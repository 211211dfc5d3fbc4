#include "timeline.h"

#include <cstdarg>
#include <cstdio>

namespace hvd {

void Timeline::Initialize(const std::string& path) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ != nullptr) {
    // Re-Init in the same process (elastic recovery, autotune's
    // startup-probe churn).  Same committed path → same rank: keep the
    // window open and accumulating (a probe restart must not discard
    // the run's events) — but restart the per-name FLOW counters:
    // every writing rank re-initializes at the same rendezvous, and
    // the membership epoch inside the flow id separates incarnations,
    // so cross-rank flow ids stay joined after a resize or a worker
    // relaunch (a surviving sender continuing from its old counts
    // against a relaunched receiver's zeros would desync forever).
    flow_send_.clear();
    flow_recv_.clear();
    if (path == path_) return;
    // Path changed → an elastic re-rank moved this writer's label:
    // terminate the old-rank file as valid JSON and start fresh at the
    // new name, or every post-resize event would be misattributed to
    // the dead incarnation's rank (and aligned with its stale offset).
    Out("{\"name\": \"horovod_end\", \"ph\": \"M\", \"pid\": 0}\n]\n");
    std::fflush(file_);
    std::fclose(file_);
    file_ = nullptr;
    tensor_pids_.clear();
    next_pid_ = 0;
    tune_span_open_ = false;
  }
  file_ = std::fopen(path.c_str(), "w");
  if (file_ == nullptr) {
    std::fprintf(stderr, "horovod_tpu: cannot open timeline file %s\n",
                 path.c_str());
    return;
  }
  path_ = path;
  written_ = 0;
  Out("[\n");
  start_ = std::chrono::steady_clock::now();
  last_flush_ = start_;
}

Timeline::~Timeline() {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ != nullptr) {
    // Terminate as valid JSON (the events all carry trailing commas, so
    // close with a final metadata event + bracket).  Chrome tracing
    // tolerates the unterminated form too — this is for `timeline
    // merge` and any strict JSON consumer.
    Out("{\"name\": \"horovod_end\", \"ph\": \"M\", \"pid\": 0}\n]\n");
    std::fflush(file_);
    std::fclose(file_);
    file_ = nullptr;
  }
}

void Timeline::Out(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  int n = std::vfprintf(file_, fmt, ap);
  va_end(ap);
  if (n > 0) written_ += n;
}

int64_t Timeline::NowUs() const {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now() - start_)
      .count();
}

void Timeline::SetMeta(int rank, int64_t epoch, int64_t clock_offset_ns) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  meta_rank_ = rank;
  meta_epoch_ = epoch;
  meta_offset_ns_ = clock_offset_ns;
  meta_set_ = true;
  if (file_ != nullptr) WriteMetaHeader();
}

void Timeline::WriteMetaHeader() {
  // mono_base_us: the trace's ts=0 instant on this process's monotonic
  // clock.  An event at trace time ts sits at rank-0 monotonic time
  // (ts + mono_base_us + clock_offset_us) — the merge tool's whole
  // alignment formula.
  const int64_t base_us =
      std::chrono::duration_cast<std::chrono::microseconds>(
          start_.time_since_epoch())
          .count();
  Out("{\"name\": \"horovod_meta\", \"ph\": \"M\", \"pid\": 0, "
      "\"args\": {\"rank\": %d, \"epoch\": %lld, \"mono_base_us\": %lld, "
      "\"clock_offset_us\": %lld}},\n",
      meta_rank_, static_cast<long long>(meta_epoch_),
      static_cast<long long>(base_us),
      static_cast<long long>(meta_offset_ns_ / 1000));
}

void Timeline::MaybeRotate() {
  if (max_bytes_ <= 0 || written_ <= max_bytes_ || path_.empty()) return;
  // Terminate the full file as valid JSON, keep it as "<path>.old"
  // (newest-but-one window), and continue fresh at the configured path —
  // the newest events always live in the file the operator configured.
  Out("{\"name\": \"horovod_rotated\", \"ph\": \"M\", \"pid\": 0}\n]\n");
  std::fflush(file_);
  std::fclose(file_);
  std::string old = path_ + ".old";
  std::rename(path_.c_str(), old.c_str());
  file_ = std::fopen(path_.c_str(), "w");
  if (file_ == nullptr) return;
  written_ = 0;
  Out("[\n");
  if (meta_set_) WriteMetaHeader();
  // Re-emit pid metadata so the fresh file is self-contained.
  for (const auto& kv : tensor_pids_) {
    Out("{\"name\": \"process_name\", \"ph\": \"M\", \"pid\": %d, "
        "\"args\": {\"name\": \"%s\"}},\n",
        kv.second, kv.first.c_str());
    Out("{\"name\": \"process_sort_index\", \"ph\": \"M\", \"pid\": %d, "
        "\"args\": {\"sort_index\": %d}},\n",
        kv.second, kv.second);
  }
}

void Timeline::Flush() {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ != nullptr) std::fflush(file_);
}

int Timeline::TensorPid(const std::string& name) {
  auto it = tensor_pids_.find(name);
  if (it != tensor_pids_.end()) return it->second;
  int pid = next_pid_++;
  tensor_pids_[name] = pid;
  // Metadata event naming the "process" after the tensor (reference
  // timeline.cc:51-68).
  Out("{\"name\": \"process_name\", \"ph\": \"M\", \"pid\": %d, "
      "\"args\": {\"name\": \"%s\"}},\n",
      pid, name.c_str());
  Out("{\"name\": \"process_sort_index\", \"ph\": \"M\", "
      "\"pid\": %d, \"args\": {\"sort_index\": %d}},\n",
      pid, pid);
  return pid;
}

void Timeline::WriteEvent(int pid, char phase, const std::string& category,
                          const std::string& op_name, int tid) {
  Out("{\"ph\": \"%c\", \"ts\": %lld, \"pid\": %d, \"tid\": %d", phase,
      static_cast<long long>(NowUs()), pid, tid);
  if (!category.empty()) {
    Out(", \"cat\": \"%s\"", category.c_str());
  }
  if (!op_name.empty()) {
    Out(", \"name\": \"%s\"", op_name.c_str());
  }
  Out("},\n");
  MaybeRotate();
  FlushIfDue();
}

void Timeline::FlushIfDue() {
  auto now = std::chrono::steady_clock::now();
  if (now - last_flush_ > std::chrono::seconds(1)) {
    std::fflush(file_);
    last_flush_ = now;
  }
}

void Timeline::NegotiateStart(const std::string& name) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'B', "NEGOTIATE", "NEGOTIATE");
}

void Timeline::NegotiateRankReady(const std::string& name, int rank) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'X', "NEGOTIATE",
             "rank_" + std::to_string(rank) + "_ready");
}

void Timeline::NegotiateEnd(const std::string& name) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'E', "NEGOTIATE");
}

void Timeline::NegotiateCached(const std::string& name) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'X', "NEGOTIATE", "NEGOTIATE_CACHED");
}

void Timeline::FlowSend(const std::string& name, int64_t epoch) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  const int64_t n = flow_send_[name]++;
  Out("{\"ph\": \"s\", \"ts\": %lld, \"pid\": %d, \"tid\": 0, "
      "\"cat\": \"FLOW\", \"name\": \"negotiate\", "
      "\"id\": \"%s#%lld#%lld\"},\n",
      static_cast<long long>(NowUs()), TensorPid(name), name.c_str(),
      static_cast<long long>(epoch), static_cast<long long>(n));
  MaybeRotate();
  FlushIfDue();
}

void Timeline::FlowRecv(const std::string& name, int64_t epoch) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  const int64_t n = flow_recv_[name]++;
  Out("{\"ph\": \"f\", \"bp\": \"e\", \"ts\": %lld, \"pid\": %d, "
      "\"tid\": 0, \"cat\": \"FLOW\", \"name\": \"negotiate\", "
      "\"id\": \"%s#%lld#%lld\"},\n",
      static_cast<long long>(NowUs()), TensorPid(name), name.c_str(),
      static_cast<long long>(epoch), static_cast<long long>(n));
  MaybeRotate();
  FlushIfDue();
}

void Timeline::Start(const std::string& name) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'B', "OP", name);
}

void Timeline::ActivityStart(const std::string& name,
                             const std::string& activity) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'B', "ACTIVITY", activity);
}

void Timeline::ActivityEnd(const std::string& name) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'E', "ACTIVITY");
}

void Timeline::ActivityStartCh(const std::string& name,
                               const std::string& activity, int tid) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'B', "ACTIVITY", activity, tid);
}

void Timeline::ActivityEndCh(const std::string& name, int tid) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'E', "ACTIVITY", "", tid);
}

void Timeline::Algo(const std::string& name, const char* algo) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'X', "ACTIVITY", algo);
}

void Timeline::PartialCommit(const std::string& name,
                             const std::string& skipped) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  WriteEvent(TensorPid(name), 'X', "ACTIVITY",
             "PARTIAL_COMMIT(skipped=" + skipped + ")");
}

void Timeline::TuneTrial(const std::string& config, bool commit) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  int pid = TensorPid("autotune");
  if (tune_span_open_) {
    WriteEvent(pid, 'E', "AUTOTUNE", "", 1);
    tune_span_open_ = false;
  }
  if (commit) {
    WriteEvent(pid, 'X', "AUTOTUNE", "TUNE_COMMIT(" + config + ")", 1);
    return;
  }
  WriteEvent(pid, 'X', "AUTOTUNE", "TUNE_TRIAL(" + config + ")", 1);
  // The scoring-window span: open until the next trial/commit applies.
  WriteEvent(pid, 'B', "AUTOTUNE", "TUNE_TRIAL(" + config + ")", 1);
  tune_span_open_ = true;
}

void Timeline::End(const std::string& name, DataType dtype,
                   const std::string& shape) {
  std::lock_guard<std::recursive_mutex> lk(mu_);
  if (file_ == nullptr) return;
  int pid = TensorPid(name);
  Out("{\"ph\": \"E\", \"ts\": %lld, \"pid\": %d, \"args\": "
      "{\"dtype\": \"%s\", \"shape\": \"%s\"}},\n",
      static_cast<long long>(NowUs()), pid, DataTypeName(dtype),
      shape.c_str());
  MaybeRotate();
  FlushIfDue();
}

}  // namespace hvd
