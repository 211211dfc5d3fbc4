// Core abstractions of the native runtime.
//
// TPU-native rebuild of the reference framework-agnostic seam
// (reference horovod/common/common.h:37-110: Status/TensorShape/Tensor/
// OpContext) — redesigned for a host-driven engine whose data plane is
// CPU buffers handed over a C ABI (ctypes), with the accelerator hot path
// living entirely in XLA.  No framework allocation inversion is needed:
// callers own their buffers; the engine owns fusion scratch.
#pragma once

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace hvd {

enum class StatusType : uint8_t {
  OK = 0,
  UNKNOWN = 1,
  PRECONDITION = 2,
  ABORTED = 3,
  INVALID_ARGUMENT = 4,
  IN_PROGRESS = 5,
};

class Status {
 public:
  Status() : type_(StatusType::OK) {}
  Status(StatusType type, std::string reason)
      : type_(type), reason_(std::move(reason)) {}
  static Status OK() { return Status(); }
  static Status Unknown(std::string r) {
    return Status(StatusType::UNKNOWN, std::move(r));
  }
  static Status PreconditionError(std::string r) {
    return Status(StatusType::PRECONDITION, std::move(r));
  }
  static Status Aborted(std::string r) {
    return Status(StatusType::ABORTED, std::move(r));
  }
  static Status InvalidArgument(std::string r) {
    return Status(StatusType::INVALID_ARGUMENT, std::move(r));
  }
  static Status InProgress() { return Status(StatusType::IN_PROGRESS, ""); }
  bool ok() const { return type_ == StatusType::OK; }
  bool in_progress() const { return type_ == StatusType::IN_PROGRESS; }
  StatusType type() const { return type_; }
  const std::string& reason() const { return reason_; }

 private:
  StatusType type_;
  std::string reason_;
};

// Wire dtypes (superset of reference mpi_message.h:26-37: adds BFLOAT16,
// the TPU-native reduced precision).
enum class DataType : uint8_t {
  UINT8 = 0,
  INT8 = 1,
  UINT16 = 2,
  INT16 = 3,
  INT32 = 4,
  INT64 = 5,
  FLOAT16 = 6,
  FLOAT32 = 7,
  FLOAT64 = 8,
  BOOL = 9,
  BFLOAT16 = 10,
};

inline size_t DataTypeSize(DataType dt) {
  switch (dt) {
    case DataType::UINT8:
    case DataType::INT8:
    case DataType::BOOL:
      return 1;
    case DataType::UINT16:
    case DataType::INT16:
    case DataType::FLOAT16:
    case DataType::BFLOAT16:
      return 2;
    case DataType::INT32:
    case DataType::FLOAT32:
      return 4;
    case DataType::INT64:
    case DataType::FLOAT64:
      return 8;
  }
  return 0;
}

inline const char* DataTypeName(DataType dt) {
  switch (dt) {
    case DataType::UINT8: return "uint8";
    case DataType::INT8: return "int8";
    case DataType::UINT16: return "uint16";
    case DataType::INT16: return "int16";
    case DataType::INT32: return "int32";
    case DataType::INT64: return "int64";
    case DataType::FLOAT16: return "float16";
    case DataType::FLOAT32: return "float32";
    case DataType::FLOAT64: return "float64";
    case DataType::BOOL: return "bool";
    case DataType::BFLOAT16: return "bfloat16";
  }
  return "?";
}

// Negotiated per-response WIRE format for allreduce payloads
// (HOROVOD_WIRE_DTYPE, overridable per tensor from the frontend).  The
// tensor keeps its own dtype end to end; the wire dtype only governs the
// bytes between ranks: fp16/bf16 wires carry RNE-converted halves, and
// int8/fp8 wires carry per-chunk-scaled quantized blocks
// (``[fp32 scale][block]``, block sized to HOROVOD_CHUNK_BYTES).  FP32
// (the default) is byte-identical to the uncompressed engine.  Applies to
// FLOAT32 allreduce only; every other dtype/op wires at its own format.
enum class WireDtype : uint8_t {
  FP32 = 0,
  FP16 = 1,
  BF16 = 2,
  INT8 = 3,
  FP8 = 4,   // e4m3 with per-chunk scales (saturating, no inf)
};

inline const char* WireDtypeName(WireDtype w) {
  switch (w) {
    case WireDtype::FP32: return "fp32";
    case WireDtype::FP16: return "fp16";
    case WireDtype::BF16: return "bf16";
    case WireDtype::INT8: return "int8";
    case WireDtype::FP8: return "fp8";
  }
  return "?";
}

class TensorShape {
 public:
  void AddDim(int64_t d) { dims_.push_back(d); }
  int ndim() const { return static_cast<int>(dims_.size()); }
  int64_t dim(int i) const { return dims_[i]; }
  const std::vector<int64_t>& dims() const { return dims_; }
  int64_t num_elements() const {
    int64_t n = 1;
    for (auto d : dims_) n *= d;
    return n;
  }
  bool operator==(const TensorShape& o) const { return dims_ == o.dims_; }
  bool operator!=(const TensorShape& o) const { return dims_ != o.dims_; }
  std::string DebugString() const {
    std::string s = "[";
    for (size_t i = 0; i < dims_.size(); ++i) {
      if (i) s += ", ";
      s += std::to_string(dims_[i]);
    }
    return s + "]";
  }

 private:
  std::vector<int64_t> dims_;
};

}  // namespace hvd
