// Chrome-tracing timeline writer.
//
// Feature parity with the reference Timeline (horovod/common/timeline.{h,cc}
// + docs/timeline.md): rank-0 writes a chrome://tracing JSON stream; each
// tensor is a trace "process" (pid); nested B/E events cover NEGOTIATE and
// execution activities (QUEUE, FUSE, RING_ALLREDUCE, ...); enabled via
// HOROVOD_TIMELINE=<path>.  Thread-safe; flushed once per second.
#pragma once

#include <chrono>
#include <cstdio>
#include <mutex>
#include <string>
#include <unordered_map>

#include "common.h"

namespace hvd {

class Timeline {
 public:
  void Initialize(const std::string& path);
  bool Initialized() const { return file_ != nullptr; }
  // Merged-timeline header: one metadata event carrying the writer's
  // rank, membership epoch, monotonic base of the trace's ts axis, and
  // the rendezvous-estimated clock offset to rank 0 — everything
  // `python -m horovod_tpu.timeline merge` needs to put every rank's
  // events on one aligned time axis.  Re-emitted after a rotation so
  // the newest file stays self-contained.
  void SetMeta(int rank, int64_t epoch, int64_t clock_offset_ns);
  // HOROVOD_TIMELINE_MAX_MB rotation: when the file exceeds this many
  // bytes it is terminated as valid JSON, renamed to "<path>.old"
  // (replacing any previous rotation), and a fresh file (meta header +
  // known pid metadata re-emitted) continues at the same path — the
  // newest events are always in the configured file.  0 = unbounded.
  void SetMaxBytes(int64_t max_bytes) { max_bytes_ = max_bytes; }
  // Flush buffered events now (abort paths: the last cycle before a
  // crash must never be lost to stdio buffering).
  void Flush();
  // Cross-rank flow trace (Dapper-style): the coordinator emits the
  // flow SOURCE ("s") when it commits a negotiation, every executing
  // rank emits the SINK ("f") on its execution span.  The flow id is
  // the string "<name>#<epoch>#<n>" with n a per-name occurrence
  // counter — identical across ranks because every commit executes
  // exactly once on every rank, so the merged trace joins them without
  // any cross-file bookkeeping.
  void FlowSend(const std::string& name, int64_t epoch);
  void FlowRecv(const std::string& name, int64_t epoch);

  void NegotiateStart(const std::string& name);
  void NegotiateRankReady(const std::string& name, int rank);
  void NegotiateEnd(const std::string& name);
  // Negotiation satisfied from the response cache: one instantaneous
  // NEGOTIATE_CACHED marker instead of a NEGOTIATE span — the visual
  // proof that a tensor skipped full coordinator negotiation.
  void NegotiateCached(const std::string& name);
  void Start(const std::string& name);                    // top-level op
  void ActivityStart(const std::string& name, const std::string& activity);
  void ActivityEnd(const std::string& name);
  // Per-channel activity spans: each data-plane channel gets its own
  // trace "thread" (tid) under the tensor's pid, so concurrent channel
  // shards render as parallel tracks instead of corrupting the main
  // track's B/E nesting (tid 0 stays reserved for the op-level spans).
  void ActivityStartCh(const std::string& name, const std::string& activity,
                       int tid);
  void ActivityEndCh(const std::string& name, int tid);
  // Size-based algorithm selection: one instantaneous ALGO_SMALL /
  // ALGO_RING marker per allreduce response, so a trace shows which
  // responses took the latency star vs. the bandwidth ring.
  void Algo(const std::string& name, const char* algo);
  // Backup-worker partial commit: one instantaneous
  // PARTIAL_COMMIT(skipped=...) marker naming the ranks the coordinator
  // left out of this response (straggler forensics on the trace).
  void PartialCommit(const std::string& name, const std::string& skipped);
  // Online-autotuner trials live on one dedicated trace "process"
  // (pid "autotune"): each applied trial writes an instantaneous
  // TUNE_TRIAL(config...) marker plus a span that covers its scoring
  // window — the span ends when the NEXT trial (or the commit) applies,
  // so a trace visually shows which trial's window hurt.  `commit`
  // closes the open span and drops a TUNE_COMMIT marker instead of
  // opening a new window.
  void TuneTrial(const std::string& config, bool commit);
  void End(const std::string& name, DataType dtype, const std::string& shape);

  ~Timeline();

 private:
  int64_t NowUs() const;
  int TensorPid(const std::string& name);
  void WriteEvent(int pid, char phase, const std::string& category,
                  const std::string& op_name = "", int tid = 0);
  void FlushIfDue();
  void WriteMetaHeader();
  void MaybeRotate();
  // fprintf wrapper that feeds the rotation byte counter.
  void Out(const char* fmt, ...) __attribute__((format(printf, 2, 3)));

  FILE* file_ = nullptr;
  std::recursive_mutex mu_;
  bool tune_span_open_ = false;
  std::unordered_map<std::string, int> tensor_pids_;
  std::chrono::steady_clock::time_point start_;
  std::chrono::steady_clock::time_point last_flush_;
  int next_pid_ = 0;
  std::string path_;
  int64_t max_bytes_ = 0;
  int64_t written_ = 0;
  bool meta_set_ = false;
  int meta_rank_ = 0;
  int64_t meta_epoch_ = 0;
  int64_t meta_offset_ns_ = 0;
  // Per-name flow occurrence counters (send side / recv side — rank 0
  // uses both, workers only the recv side).
  std::unordered_map<std::string, int64_t> flow_send_, flow_recv_;
};

}  // namespace hvd
