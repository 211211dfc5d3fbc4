// The native runtime engine: background coordinator + host data plane.
//
// Functional parity with the reference core (horovod/common/operations.cc):
//   * HorovodGlobalState      → Engine singleton (tensor table, message
//     queue, background thread, fusion buffer, knobs)
//   * BackgroundThreadLoop / RunLoopOnce (operations.cc:1435-1907)
//     → Engine::BackgroundLoop / RunLoopOnce — a lock-step negotiation
//     cycle every HOROVOD_CYCLE_TIME ms (default 5)
//   * rank-0 coordinator protocol (MPI_Gather/v + MPI_Bcast of
//     FlatBuffers lists) → length-prefixed TCP frames to/from the
//     coordinator address (JAX-style rendezvous, no mpirun)
//   * IncrementTensorCount / ConstructMPIResponse (operations.cc:282-517)
//     → MessageTable readiness counting + full cross-rank validation
//   * tensor fusion buffer (operations.cc:149-165, 1815-1842)
//     → same-dtype ready allreduces packed into one ring collective
//   * MPI_Allreduce/Allgatherv/Bcast data plane (operations.cc:1232-1353)
//     → ring allreduce (reduce-scatter + allgather over neighbor TCP
//       sockets — the classic bandwidth-optimal ring the reference gets
//       from NCCL), frame-forwarding ring allgather, pipelined ring
//       broadcast
//   * stall detection (operations.cc:1366-1412) → StallCheck
//   * Timeline hooks (operations.cc:698-710) → timeline.h
//
// The accelerator hot path does NOT go through this engine — jitted SPMD
// programs use XLA collectives over ICI.  This engine serves the host-driven
// paths: eager collectives, the torch frontend, parameter/optimizer
// broadcast, metric averaging, and cross-process (DCN) reductions.
#pragma once

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "common.h"
#include "flightrec.h"
#include "message.h"
#include "shm.h"
#include "socket.h"
#include "timeline.h"

namespace hvd {

// Fixed order of TelemEntry::deltas (the fleet-telemetry counter set).
// Keep in lockstep with horovod_tpu/monitor/metrics.py TELEM_COUNTERS —
// the wire carries positions, not names.
enum TelemCounter {
  TC_DATA_BYTES_TX = 0,
  TC_DATA_BYTES_RX,
  TC_ALLREDUCE_BYTES,
  TC_REDUCESCATTER_BYTES,
  TC_NEGOTIATION_BYTES_TX,
  TC_NEGOTIATION_BYTES_RX,
  TC_CONTROL_ROUND_TRIPS,
  TC_CACHE_HITS,
  TC_CACHE_MISSES,
  TC_TENSORS,
  TC_RESPONSES,
  TC_EXEC_CYCLES,
  TC_SHM_BYTES_TX,
  TC_COMPRESSED_BYTES_TX,
  TC_WIRE_BYTES_SAVED,
  TC_BACKUP_SKIPS,
  TC_STALE_EPOCH_MSGS,
  TC_STALL_WARNINGS,
  TC_PRIORITY_INVERSIONS,
  // Appended entries (PR 20) — the wire carries positions, so new
  // counters only ever go at the END, before TC_COUNT.
  TC_ALLTOALL_BYTES,
  TC_MOE_TOKENS_DROPPED,
  TC_COUNT,
};
extern const char* const kTelemCounterNames[TC_COUNT];

struct TensorTableEntry {
  std::string name;
  RequestType type = RequestType::ALLREDUCE;
  DataType dtype = DataType::FLOAT32;
  TensorShape shape;
  void* data = nullptr;   // caller-owned; in/out for allreduce & broadcast
  int root_rank = -1;
  ReduceOp red_op = ReduceOp::SUM;
  // Resolved wire format this entry was REQUESTED with (global knob or
  // per-tensor override at enqueue time) — part of the cache signature
  // and of any resubmitted Request, so renegotiations keep the format.
  // wire_default marks a knob-derived (advisory) resolution — see
  // Request::wire_default.
  WireDtype wire_dtype = WireDtype::FP32;
  bool wire_default = false;
  // Scheduling priority (0 = most urgent; see Request::priority).
  int32_t priority = 0;
  // Alltoall: this rank's per-destination dim-0 split sizes (see
  // Request::splits).  Empty = legacy equal splits.
  std::vector<int64_t> splits;
  int64_t handle = -1;
  // Enqueue wall-clock: FinishEntry derives the per-collective
  // completion latency (step_time_ns percentiles) from it.
  std::chrono::steady_clock::time_point enqueue_time;
};

struct HandleState {
  std::atomic<int> done{0};   // 0 pending, 1 ok, -1 error
  std::string error;
  // Ranks whose data the committed response actually reduced: size for
  // a full commit, the participant-set size for a backup-worker partial
  // commit, 0 when this rank's entry was skipped — divisor-correct
  // averaging in the frontends divides by THIS, never blindly by size.
  int participants = 0;
  // Allgather result (shape negotiated at runtime, reference
  // operations.cc:796-856): buffered here, copied out by the caller.
  std::vector<uint8_t> result;
  std::vector<int64_t> result_shape;
};

// Small data-plane thread pool (HOROVOD_NUM_CHANNELS workers): drives the
// per-channel ring shards of a sharded collective, executes independent
// responses of one cycle concurrently, and lends idle workers to large
// reductions.  Tasks must be data-plane leaves or channel drivers — the
// only nested use is TrySubmitIfIdle (which never queues behind a busy
// worker), so the pool cannot deadlock on itself.
class DataPool {
 public:
  ~DataPool() { Stop(); }
  void Start(int nthreads);
  void Stop();
  void Submit(std::function<void()> fn);
  // Enqueue only if an idle worker can take the task right now; the
  // caller runs it inline otherwise.  Safe to call from a pool task.
  bool TrySubmitIfIdle(std::function<void()> fn);
  int size() const { return static_cast<int>(threads_.size()); }

 private:
  void Loop();
  std::vector<std::thread> threads_;
  std::deque<std::function<void()>> q_;
  std::mutex mu_;
  std::condition_variable cv_;
  int idle_ = 0;
  bool stop_ = false;
};

// Completion latch for a batch of pool tasks.
class TaskLatch {
 public:
  explicit TaskLatch(int n) : n_(n) {}
  void Done() {
    std::lock_guard<std::mutex> lk(mu_);
    if (--n_ <= 0) cv_.notify_all();
  }
  void Wait() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [&] { return n_ <= 0; });
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  int n_;
};

class Engine {
 public:
  static Engine& Get();

  // Returns 0 on success; nonzero + FillLastError on failure.
  int Init(int rank, int size, int local_rank, int local_size,
           const std::string& coordinator_addr);
  void Shutdown();

  bool initialized() const { return initialized_.load(); }
  int rank() const { return rank_; }
  int size() const { return size_; }
  int local_rank() const { return local_rank_; }
  int local_size() const { return local_size_; }
  // Committed membership epoch: bumped by every successful rendezvous
  // commit (first init and every re-init).  Workers adopt the
  // coordinator's value, so all live members of a world agree on it and
  // every control frame carries it (stale frames from a dead incarnation
  // are structurally rejected — see stale_epoch_msgs).
  int64_t epoch() const { return epoch_.load(); }
  const std::string& last_error() const { return last_error_; }

  // Enqueue a collective on caller-owned memory.  Returns a handle, or -1
  // (duplicate name in flight — reference DUPLICATE_NAME_ERROR,
  // operations.cc:2058-2061) or -2 (not initialized / shut down).
  // `probe` marks a dense allreduce as a layout probe (see Request::probe):
  // it completes normally unless peers are gathering the tensor sparsely,
  // in which case the handle fails with the magic "__sparse_retry__:<dim>"
  // error and the caller re-enqueues zero-entry sparse gathers.
  // `wire_dtype` < 0 uses the live global knob (HOROVOD_WIRE_DTYPE /
  // TUNE); >= 0 is a per-tensor override.  Only FLOAT32 allreduces ever
  // wire compressed; everything else is forced to the fp32 wire (i.e.
  // its own dtype's bytes, exactly the pre-compression engine).
  // `priority` (>= 0; 0 = most urgent, the default) is the scheduling
  // priority frontends stamp from registration order — see
  // Request::priority.  `wire_advisory` marks an explicit wire_dtype as
  // knob-like (Request::wire_default): the coordinator commits the first
  // value on a cross-rank disagreement instead of erroring — the seam
  // the statistics-driven wire policy uses, since per-rank gradient
  // stats may legitimately disagree for a step.
  // `splits` (alltoall only): per-destination dim-0 row counts, size_
  // entries summing to shape[0]; empty = legacy equal splits (shape[0]
  // divisible by world size).
  int64_t Enqueue(RequestType type, const std::string& name, DataType dtype,
                  const std::vector<int64_t>& shape, void* data,
                  int root_rank, ReduceOp red_op = ReduceOp::SUM,
                  bool probe = false, int wire_dtype = -1,
                  int priority = 0, bool wire_advisory = false,
                  const std::vector<int64_t>& splits = {});

  // Execution stats (readable from any thread).  `exec_cycles` counts
  // negotiation cycles that executed at least one response on this rank;
  // `responses_executed` counts responses (a fused batch is ONE);
  // `tensors_executed` counts tensors.  tensors/responses > 1 ⇒ fusion;
  // frontends batching N tensors into one cycle see exec_cycles grow by
  // ~1 instead of N (reference async+fusion property,
  // operations.cc:1815-1842).
  int64_t exec_cycles() const { return exec_cycles_.load(); }
  int64_t responses_executed() const { return responses_executed_.load(); }
  int64_t tensors_executed() const { return tensors_executed_.load(); }

  // Response-cache / control-plane observability.  `cache_hits` counts
  // enqueues negotiated as a single slot bit; `cache_misses` counts
  // cacheable-type enqueues that went through full negotiation (first
  // sight of a signature, renegotiation after an evict);
  // `cache_evictions` counts slots dropped from this rank's replica.
  // `negotiation_bytes_tx/rx` sum control-frame payloads (+8-byte length
  // prefix) from this process's perspective; `control_round_trips`
  // counts request→response exchanges that carried NEGOTIATION payload
  // (requests, hit bits, evicts, responses, cached slots, or shutdown —
  // idle heartbeat cycles are excluded) — bench divides it by steps to
  // show the cache collapsing per-tensor negotiation into ~1 round trip
  // per step.
  int64_t cache_hits() const { return cache_hits_.load(); }
  int64_t cache_misses() const { return cache_misses_.load(); }
  int64_t cache_evictions() const { return cache_evictions_.load(); }
  int64_t negotiation_bytes_tx() const { return negotiation_bytes_tx_.load(); }
  int64_t negotiation_bytes_rx() const { return negotiation_bytes_rx_.load(); }
  int64_t control_round_trips() const { return control_round_trips_.load(); }
  // Rendezvous ASSIGN traffic this coordinator sent (frame bytes + the
  // 8-byte length prefix, summed over members and re-rendezvous) — the
  // deterministic counter the scale harness tracks across world sizes.
  int64_t assign_bytes_tx() const { return assign_bytes_tx_.load(); }
  // Control-plane cycle time on the coordinator: wall time from the
  // start of a payload-carrying cycle's frame gathering to the last
  // response send (execution excluded).  p50/p99 over a sliding window
  // of recent cycles, 0 when no sample exists (workers, idle worlds).
  int64_t coordinator_cycle_ns_p50() const {
    return CoordCycleNsPercentile(0.50);
  }
  int64_t coordinator_cycle_ns_p99() const {
    return CoordCycleNsPercentile(0.99);
  }
  // Hierarchical coordination (HOROVOD_HIERARCHICAL_COORDINATOR,
  // committed in the ASSIGN frame): sub-coordinators per host group
  // aggregate readiness so rank 0 handles O(hosts) control frames.
  bool hier_coordinator() const { return hier_coord_; }
  // Control frames dropped because they were stamped with a different
  // membership epoch than this rank's committed one (a delayed message
  // from a dead incarnation after an elastic resize).
  int64_t stale_epoch_msgs() const { return stale_epoch_msgs_.load(); }

  // Data-plane observability.  `data_bytes_tx/rx` sum payload bytes this
  // process moved over ring data sockets (all collective types, all
  // channels); `wire_ns` is cumulative time threads spent progressing
  // data sockets (poll/send/recv) and `reduce_ns` cumulative time inside
  // reduction kernels — both sum ACROSS channels/threads, so either may
  // exceed wall time when channels overlap.  `allreduce_bytes`/
  // `allreduce_ns` sum ring-allreduce payload bytes and wall time; the
  // Python stats() derives allreduce_bus_bw_bytes_per_sec =
  // 2(N-1)/N · bytes / wall from them.  `num_channels` is the COMMITTED
  // per-edge channel count (the coordinator's HOROVOD_NUM_CHANNELS wins
  // at rendezvous so every rank wires the same fan-out).
  int64_t data_bytes_tx() const { return data_bytes_tx_.load(); }
  int64_t data_bytes_rx() const { return data_bytes_rx_.load(); }
  int64_t reduce_ns() const { return reduce_ns_.load(); }
  int64_t wire_ns() const { return wire_ns_.load(); }
  int64_t allreduce_bytes() const { return allreduce_bytes_.load(); }
  int64_t allreduce_ns() const { return allreduce_ns_.load(); }
  // Reduce-scatter observability: payload bytes and wall time of
  // REDUCESCATTER responses (the bus-bandwidth convention for RS is
  // (N-1)/N · bytes / wall — half the allreduce numerator, matching its
  // wire pattern), plus how many responses had to take the exact-parity
  // FALLBACK (full allreduce + local slice: unaligned multi-dim shard
  // geometry or a block-quantized wire) instead of the half-cascade.
  int64_t reducescatter_bytes() const { return reducescatter_bytes_.load(); }
  int64_t reducescatter_ns() const { return reducescatter_ns_.load(); }
  int64_t reducescatter_fallback_count() const {
    return reducescatter_fallback_count_.load();
  }
  // Alltoall observability: payload bytes (full input buffer per
  // response — what the variable-split ring circulates scales it by
  // (N-1)/N, which is also the alltoall busbw numerator convention) and
  // cumulative wall time of ALLTOALL responses.
  int64_t alltoall_bytes() const { return alltoall_bytes_.load(); }
  int64_t alltoall_ns() const { return alltoall_ns_.load(); }
  // MoE plane accounting (runtime/moe.py): cumulative tokens dropped by
  // capacity-factor truncation, noted per dispatch from Python so the
  // counter rides the TELEM fleet aggregation like sharded_steps.
  int64_t moe_tokens_dropped() const { return moe_tokens_dropped_.load(); }
  void NoteMoeDispatch(int64_t dropped) {
    moe_tokens_dropped_.fetch_add(dropped);
  }
  // Sharded-optimizer steps (ZeRO-1: reducescatter(grads) → shard-local
  // update → allgather) completed by the Python frontends on this
  // process — noted like local_sgd_syncs, cumulative.
  int64_t sharded_steps() const { return sharded_steps_.load(); }
  void NoteShardedStep() { sharded_steps_.fetch_add(1); }
  int num_channels() const { return num_channels_; }

  // Shared-memory / hierarchy observability.  `shm_bytes_tx/rx` sum
  // payload bytes this process moved through shm rings (they also count
  // into data_bytes_tx/rx — shm is a transport of the same data plane);
  // `intra_host_bytes` sums payload exchanged with co-located ranks
  // (tx + rx); `algo_small_count/algo_ring_count` count allreduce
  // responses executed via the latency-optimized star path vs. the
  // bandwidth-optimized ring; `topology_hosts` × per-host group sizes is
  // the committed host grouping (this rank reports its own group's size).
  int64_t shm_bytes_tx() const { return shm_bytes_tx_.load(); }
  int64_t shm_bytes_rx() const { return shm_bytes_rx_.load(); }
  int64_t intra_host_bytes() const { return intra_host_bytes_.load(); }
  int64_t algo_small_count() const { return algo_small_count_.load(); }
  int64_t algo_ring_count() const { return algo_ring_count_.load(); }
  int topology_hosts() const { return nnodes_; }
  int topology_local_ranks() const { return group_size_; }
  bool shm_enabled() const { return shm_enabled_; }
  int64_t algo_threshold() const { return algo_threshold_.load(); }

  // Wire-compression observability.  `wire_bytes_saved` sums, per
  // compressed allreduce response, logical payload bytes minus
  // wire-representation bytes (buffer-level: how much smaller the wire
  // format is; ring traffic scales it by ~2(N-1)/N).
  // `compressed_bytes_tx` sums ring payload bytes this rank sent in a
  // compressed wire format; `quantize_ns` is cumulative thread-time in
  // the (de)quantization kernels; the per-mode counters count allreduce
  // RESPONSES executed under each wire format.
  int64_t wire_bytes_saved() const { return wire_bytes_saved_.load(); }
  int64_t compressed_bytes_tx() const { return compressed_bytes_tx_.load(); }
  int64_t quantize_ns() const { return quantize_ns_.load(); }
  int64_t wire_fp16_count() const { return wire_fp16_count_.load(); }
  int64_t wire_bf16_count() const { return wire_bf16_count_.load(); }
  int64_t wire_int8_count() const { return wire_int8_count_.load(); }
  int64_t wire_fp8_count() const { return wire_fp8_count_.load(); }
  // Effective default wire dtype (live-tunable knob #6).
  int wire_dtype() const { return wire_dtype_.load(); }

  // Priority scheduling (HOROVOD_PRIORITY_BANDS, live-tunable knob #7).
  // `priority_bands` is the committed band WIDTH (band = priority /
  // width; 0 = off = bit-identical legacy arrival ordering);
  // `priority_inversions` counts committed responses dispatched after a
  // strictly less-urgent (higher-priority-number) response of the SAME
  // cycle — deterministic (dispatch-list order, not wall clock), and by
  // construction 0 with bands on.  `fusion_ladder(b)` is band b's
  // effective fusion threshold (0 = fall back to the global knob).
  int64_t priority_bands() const { return priority_bands_.load(); }
  int64_t priority_inversions() const {
    return priority_inversions_.load();
  }
  static constexpr int kFusionLadderMax = 8;
  int64_t fusion_ladder(int band) const {
    if (band < 0) return 0;
    if (band >= kFusionLadderMax) band = kFusionLadderMax - 1;
    return fusion_ladder_[band].load();
  }

  // Straggler-tolerance observability.  `backup_workers` is the
  // committed HOROVOD_BACKUP_WORKERS over-provisioning (rendezvous
  // commits the coordinator's value, like the channel count);
  // `backup_skips` counts responses THIS rank was left out of (its
  // entries finished with the clean "skipped this step" status);
  // `local_sgd_syncs` counts outer local-SGD delta syncs the Python
  // policy completed on this process (NoteLocalSgdSync);
  // `step_time_ns_p50/p99` are percentiles of allreduce completion
  // latency (enqueue → finish, successful entries only) over a sliding
  // window — the deterministic per-rank instrument the straggler gate
  // judges: one slow rank inflates every participant's p99 at k=0, and
  // backup-worker commits pull it back down.
  int backup_workers() const { return backup_workers_; }
  // HOROVOD_BACKUP_WORKERS=auto: the coordinator arms k=1 only while
  // the step-time window ratio p99/p50 exceeds
  // HOROVOD_BACKUP_AUTO_RATIO (default 3.0) — a cheap straggler
  // detector on the percentile instrument the straggler gate already
  // trusts.  `backup_auto` reports the mode, `backup_armed` whether the
  // rule currently arms partial commits (coordinator-evaluated; workers
  // report 0 — commits reach them in responses), and the ratio is
  // exported in milli-units so the C ABI stays int64-only.
  bool backup_auto() const { return backup_auto_; }
  int64_t backup_auto_ratio_milli() const {
    return static_cast<int64_t>(backup_auto_ratio_ * 1000.0 + 0.5);
  }
  bool backup_armed() const { return backup_armed_.load(); }
  int64_t backup_skips() const { return backup_skips_.load(); }
  // Link self-healing observability (HOROVOD_LINK_RETRIES /
  // HOROVOD_LINK_HEAL_TIMEOUT_MS).  `link_reconnects` counts data-channel
  // edges transparently re-established mid-collective (each healed edge
  // counts once per endpoint: the sender that re-dialed and the receiver
  // that accepted+ACKed); `link_heal_failures` counts suspects that
  // exhausted the retry/deadline budget and escalated to the unchanged
  // abort path; `link_heal_ns_p50/p99` are sliding-window percentiles of
  // suspect→healed durations on this rank.  All zero under
  // HOROVOD_LINK_RETRIES=0 — the observable proof healing never ran.
  int64_t link_reconnects() const { return link_reconnects_.load(); }
  int64_t link_heal_failures() const { return link_heal_failures_.load(); }
  int64_t link_heal_ns_p50() const { return LinkHealNsPercentile(0.50); }
  int64_t link_heal_ns_p99() const { return LinkHealNsPercentile(0.99); }
  int link_retries() const { return link_retries_; }
  int64_t link_heal_timeout_ms() const { return link_heal_timeout_ms_; }
  int64_t local_sgd_syncs() const { return local_sgd_syncs_.load(); }
  void NoteLocalSgdSync() { local_sgd_syncs_.fetch_add(1); }
  int64_t step_time_ns_p50() const { return StepTimeNsPercentile(0.50); }
  int64_t step_time_ns_p99() const { return StepTimeNsPercentile(0.99); }
  // Participant count recorded on a finished handle (see HandleState).
  int ResultParticipants(int64_t handle);

  // -- fleet observability (HOROVOD_TELEMETRY_CYCLES) --
  // Every `telemetry_cycles` negotiation cycles each rank piggybacks a
  // TELEM entry of counter DELTAS on its RequestList (host leaders sum
  // their group's entries into one per-host entry under hierarchical
  // coordination, so rank 0 still handles O(hosts) telemetry bytes);
  // rank 0 folds the entries into a fleet table readable via FleetJson.
  // 0 disables telemetry entirely — frames are then byte-identical to
  // the pre-telemetry wire (the section is gated on remaining bytes,
  // not a flag).  Final deltas ride the shutdown frame so fleet totals
  // of quiesced counters equal the sum of per-rank stats exactly.
  int64_t telemetry_cycles() const { return telemetry_cycles_; }
  int64_t telem_bytes_tx() const { return telem_bytes_tx_.load(); }
  // Stalled-tensor warnings emitted by this process (coordinator and
  // sub-coordinator detectors), each also mirrored into the flight
  // recorder — the source of the horovod_stall_warnings_total metric.
  int64_t stall_warnings() const { return stall_warnings_.load(); }
  // Rendezvous-estimated monotonic-clock offset to rank 0 (rank0_now ≈
  // my_now + offset; 0 on rank 0): min-RTT midpoint over the ping
  // exchange folded into the JOIN/ASSIGN handshake.  Recorded in the
  // timeline header so `timeline merge` can align per-rank tracks.
  int64_t clock_offset_ns() const { return clock_offset_ns_; }
  // Coordinator-only quorum-lag percentiles: per committed entry, how
  // long the LAST voter trailed the second-to-last (the "would one
  // backup worker have helped" instrument; HOROVOD_BACKUP_WORKERS=auto
  // arms from it under the default rule).  0 on workers / idle worlds.
  int64_t quorum_lag_ns_p50() const { return QuorumLagNsPercentile(0.50); }
  int64_t quorum_lag_ns_p99() const { return QuorumLagNsPercentile(0.99); }
  // HOROVOD_BACKUP_AUTO_RULE: 0 = quorum (default — arm k=1 while the
  // quorum-lag p50 exceeds the grace window: the median last-voter lag
  // being past the grace means a partial commit would be actionable on
  // a typical step), 1 = steptime (the PR 12 rule on rank 0's own
  // completion-latency window, kept as the documented fallback; it
  // cannot see rank 0 itself straggling).
  int backup_auto_rule() const { return backup_auto_rule_; }
  // Rank 0's fleet table as JSON (rows + totals + slowest-rank
  // attribution + quorum-lag percentiles); "{}" on workers before any
  // telemetry arrived.  Readable from any thread, including after
  // shutdown (post-mortem scrapes).
  std::string FleetJson() const;
  int64_t fleet_rows() const;
  // Manual flight-recorder dump (tests, operator tooling); returns 0 on
  // success, -1 when the recorder is disabled or has no dump dir.
  int FlightDump(const char* reason) {
    return GlobalFlightRecorder().Dump(reason);
  }

  // Effective (currently in-force) values of the live-tunable knobs plus
  // the wiring-time ones, for stats()["config"]: post-TUNE, not the env
  // default — an operator reading stats sees what the engine is actually
  // running with.
  int64_t chunk_bytes() const { return chunk_bytes_.load(); }
  int64_t fusion_threshold() const { return fusion_threshold_.load(); }
  int cycle_time_ms() const { return cycle_time_ms_.load(); }
  int wave_width() const { return wave_width_.load(); }
  int channel_drivers() const { return channel_drivers_; }
  int64_t cache_capacity() const { return cache_capacity_; }
  int socket_buf_bytes() const { return socket_buf_bytes_; }
  // TUNE frames applied on this rank (process-cumulative, like every
  // other counter).  Zero under HOROVOD_AUTOTUNE=0 — the observable
  // proof that the default path never sees a TUNE frame.
  int64_t tune_trials() const { return tune_trials_.load(); }

  // Online autotuner entry point (coordinator only, any thread): queue a
  // knob config to broadcast in the next cycle's TUNE frame.  Every rank
  // — the coordinator included — applies it BEFORE that cycle's
  // responses execute, i.e. atomically between negotiation cycles (no
  // response in flight, and no completion-woken enqueue can read a
  // stale knob a peer already flipped); the frame
  // carries the membership epoch, so a TUNE from a dead incarnation is
  // structurally dropped.  Values <= 0 leave the knob unchanged;
  // `commit` marks the search's final config (timeline/observability).
  // Returns 0 queued, -1 when not initialized or not the coordinator.
  // `priority_bands` < 0 leaves the band width unchanged (0 is real:
  // bands off); `fusion_ladder` entries <= 0 leave that band's fusion
  // threshold unchanged (empty ladder = whole ladder unchanged).
  int QueueTune(int64_t chunk_bytes, int64_t fusion_threshold,
                int64_t cycle_time_ms, int64_t wave_width,
                int64_t algo_threshold, int64_t wire_dtype,
                int64_t priority_bands,
                const std::vector<int64_t>& fusion_ladder, bool commit);

  // Why the engine aborted ("" while healthy or after a clean shutdown).
  // Safe to call from any thread: the background thread publishes
  // abort_reason_ before its shut_down_ release-store, and this reads it
  // only after observing shut_down_.
  std::string AbortReason() const;

  int Poll(int64_t handle);                  // 0 pending, 1 ok, -1 error
  int Wait(int64_t handle);                  // blocks; returns Poll result
  std::string ErrorMessage(int64_t handle);
  int64_t ResultNumDims(int64_t handle);
  int64_t ResultDim(int64_t handle, int i);
  int64_t ResultByteSize(int64_t handle);
  int CopyResult(int64_t handle, void* dst, int64_t nbytes);
  void ReleaseHandle(int64_t handle);

 private:
  Engine() = default;
  void BackgroundLoop();
  bool RunLoopOnce();                        // returns false on shutdown
  // Coordinator-led membership rendezvous (worker id 0).  First init
  // requires the full world; an elastic re-init (HOROVOD_ELASTIC=1 and a
  // previously committed epoch) waits a bounded grace window
  // (HOROVOD_ELASTIC_GROW_TIMEOUT_SEC) for relaunched/new candidates,
  // then commits whoever showed up — contiguous re-ranking sorted by
  // persistent worker id, new size, epoch+1 — or fails with a clean
  // terminal error when the survivor count is below
  // HOROVOD_ELASTIC_MIN_SIZE.  Fills the committed peer tables for ring
  // wiring; returns nonzero + last_error_ on failure.
  int CoordinatorRendezvous(const std::string& host, int port,
                            const std::string& my_host, int data_port,
                            std::vector<std::string>* peer_hosts,
                            std::vector<int>* peer_ports);
  // Worker side: join (persistent worker id = the launch-time rank), wait
  // for the ASSIGN frame, adopt (epoch, rank, size) and the peer table.
  int WorkerRendezvous(const std::string& host, int port,
                       const std::string& my_host, int data_port,
                       std::vector<std::string>* peer_hosts,
                       std::vector<int>* peer_ports);
  // Coordinator, elastic mode, once per cycle: zero-timeout probe of the
  // control listener for a join candidate (a relaunched or new worker).
  // A valid join triggers a collective abort so every member re-enters
  // rendezvous and the candidate is admitted under epoch+1; returns true
  // when the cycle loop must exit for that re-rendezvous.
  bool PollJoinCandidate();
  // -- hierarchical coordination (control-plane two-level tree) --
  // Active when the committed HOROVOD_HIERARCHICAL_COORDINATOR flag is
  // set AND the committed topology has >1 host group with >O(hosts)
  // ranks: each group's leader (lowest committed rank) aggregates its
  // members' per-cycle frames into ONE frame toward rank 0, and relays
  // rank 0's response frame back down verbatim — rank 0 exchanges
  // O(hosts) control frames per cycle instead of O(ranks).
  bool HierActive() const { return hier_coord_ && size_ > 1; }
  bool IsGroupLeader() const { return local_index_ == 0; }
  // Epoch-gated control-frame read shared by every gather point (rank 0
  // reading leaders, leaders reading members, workers reading relays):
  // drops + counts frames stamped with a stale membership epoch, bounded
  // so a peer stuck in the past cannot spin the receiver forever.
  // Returns false on transport failure / corrupt frame / stale flood,
  // with *what set to a short reason.
  bool RecvRequestListGated(Socket& conn, int patience, const char* who,
                            RequestList* out, std::string* what);
  // Leader side of one hierarchical cycle: drain the local queue, gather
  // one frame from every group member (epoch-gated), merge — member
  // requests forwarded verbatim (they carry request_rank), member hit
  // bits accumulated in sub_slot_bits_ and forwarded only once the WHOLE
  // group is ready on a slot, evicts unioned, shutdown ORed.  A member
  // transport failure does not fail the cycle: it is reported in the
  // aggregate's fail_rank/fail_message so rank 0 broadcasts the abort
  // naming the member.
  void AggregateGroup(RequestList* agg);
  // Leader → members: relay a raw response frame (identical bytes, so
  // members parse exactly what rank 0 serialized, abort verdicts and
  // TUNE payloads included).  Returns false when a member send failed.
  bool RelayToMembers(const std::vector<uint8_t>& frame);
  // Leader's own failure path: synthesize an abort ResponseList to the
  // members (they are blocked on the relay) before this leader's loop
  // exits — the sub-coordinator analogue of BroadcastAbort.
  void RelayAbortToMembers(const std::string& message);
  // Record one payload cycle's control-plane wall time (rank 0).
  void RecordCoordCycleNs(int64_t ns);
  int64_t CoordCycleNsPercentile(double p) const;
  // Pop the message queue into `my_list`, classifying each request
  // against the local cache replica: known signature → hit bit, changed
  // signature → evict + full request, unknown → full request.  Also
  // flushes requests forced back to full negotiation by a remote evict.
  void DrainMessageQueue(RequestList* my_list);
  // Worker-side replica maintenance for one response frame: apply
  // evict_slots (resubmitting any of our tensors that were riding an
  // evicted slot), then insert new slot assignments carried by the
  // responses.  Must run BEFORE the responses execute (execution drains
  // the tensor table the signatures are read from).
  void ApplyCacheUpdates(const ResponseList& list);
  // Build (but do not execute) the cycle's agreed cached slots from the
  // local replica: replayed single-tensor responses with participants
  // grafted for partial slots, fused like freshly negotiated responses
  // (band-aware under priority bands).  Returns false — aborting the
  // engine — on a replica/protocol inconsistency (an agreed slot this
  // rank does not hold), which would otherwise strand tensors forever.
  bool BuildCachedResponses(const ResponseList& list,
                            std::vector<Response>* out);
  // One cycle's full dispatch (fresh + cached): legacy fresh-then-cached
  // order with bands off, one merged (priority, name)-ordered dispatch
  // with bands on.  Sets *executed_any; returns false on a replica
  // protocol error (engine aborts).
  bool DispatchCycleResponses(ResponseList& list, bool* executed_any);
  // Coordinator-side: drop a slot everywhere (idempotent within a cycle).
  void CoordinatorEvictSlot(uint32_t slot, ResponseList* out);
  void ClearCacheState();
  // -- backup-worker straggler tolerance (HOROVOD_BACKUP_WORKERS=k) --
  // Coordinator, end of every gather cycle under k > 0: commit any SUM
  // allreduce (full-request pending entry or cached-slot readiness)
  // whose ready voter count reached nvoters-k and whose first sighting
  // is older than the grace window — the committed participant set
  // (flat: the seen ranks; hierarchical: every rank of each FULLY-seen
  // host group, a late host being one late voter) rides the response /
  // partial_slots so every rank runs the same full-world ring over the
  // same survivors' data.
  void MaybePartialCommits(ResponseList* out);
  // Validate + build a partially committed single-tensor response over
  // `participants` only (all of them seen); erases the pending entry.
  Response BuildPartialResponse(const std::string& name,
                                const std::vector<uint32_t>& participants);
  bool RankInParticipants(const std::vector<uint32_t>& parts) const;
  // A committed response left THIS rank out: finish any held entries
  // with the clean "skipped this step" status (purging their queued
  // requests so the coordinator never sees a stale late request), bank
  // skip tokens for tensors not yet enqueued, and drop consumed pending
  // hit bits.  Counted once per skipped response in backup_skips.
  void NoteSkippedResponse(const Response& response,
                           std::vector<TensorTableEntry>& entries);
  void RecordStepTimeNs(int64_t ns);
  int64_t StepTimeNsPercentile(double p) const;
  // Coordinator-only: tell every still-reachable worker that `culprit`
  // failed, so survivors abort promptly instead of waiting out their own
  // transport timeouts; sets abort_reason_ to `message`.
  void BroadcastAbort(int culprit, const std::string& message);
  ResponseList CoordinatorStep(std::vector<RequestList>& lists);
  Response BuildResponse(const std::string& name);
  void FuseResponses(std::vector<Response>& responses);
  // Which slice of the channel fan-out an execution owns: channels
  // [channel, channel + nchannels).  The serial path passes the full
  // range; a concurrent wave hands each response ONE channel so their
  // wire streams live on disjoint socket pairs.  `channel` also indexes
  // the fusion scratch slot, keeping concurrent fused batches off each
  // other's buffers.
  // Ring identities stamped into the wiring handshake (hello[1]) and the
  // link-heal RESUME frames.
  enum RingId : int32_t {
    RING_GLOBAL = 0, RING_LOCAL = 1, RING_CROSS = 2, RING_CTRL = 3,
  };
  // One channel's duplex transport toward the ring neighbors: exactly one
  // of (TCP sockets, shm edges) is set.  RingSpec bundles a whole ring's
  // identity — who I am on it, how many ranks it has, and its per-channel
  // ports — so the phase/cascade code runs unchanged over the flat TCP
  // ring, the flat shm ring, the intra-host shm ring, and the leader
  // cross-host ring.
  struct RingPort {
    Socket* next = nullptr;      // TCP: send toward ring-next
    Socket* prev = nullptr;      // TCP: recv from ring-prev
    ShmRing* shm_tx = nullptr;   // shm: send toward ring-next
    ShmRing* shm_rx = nullptr;   // shm: recv from ring-prev
    bool is_shm() const { return shm_tx != nullptr; }
  };
  // Block codec for a quantized (int8/fp8) wire: the ring's "element"
  // becomes one BLOCK of ``[fp32 scale][block_elems quantized values]``
  // (block sized to HOROVOD_CHUNK_BYTES worth of fp32 elements, last
  // block zero-padded), so segment arithmetic, channel sharding and the
  // chunk cascade all run unchanged over uniform block_bytes elements —
  // only the reduction kernel swaps to dequantize-combine-requantize
  // through fp32 staging.
  struct WireCodec {
    WireDtype wire = WireDtype::INT8;
    int64_t block_elems = 0;     // fp32 elements per block
    size_t block_bytes = 0;      // 4 (scale) + block_elems quantized bytes
  };
  struct RingSpec {
    int vrank = 0;
    int rsize = 1;
    std::vector<RingPort> ports;       // indexed by global channel id
    const char* span = "RING_CH";      // timeline activity prefix
    // Non-null: payload is block-quantized wire format (see WireCodec) —
    // the phases reduce blocks instead of elements.  `compressed` also
    // covers the fp16/bf16 staging wires (no codec, but the bytes on
    // this spec's ports are compressed payload → compressed_bytes_tx).
    const WireCodec* codec = nullptr;
    bool compressed = false;
    // Link self-healing identity: which RingId this spec's TCP edges
    // belong to, the committed neighbor ranks (reconnect targets via the
    // peer table), and the per-channel cascade stream-sequence counters
    // (both endpoints of an edge count the same deterministic response
    // sequence per channel, so a RESUME's seq identifies the exact
    // in-flight cascade).  ring_id < 0 / null seq = healing not
    // applicable (shm rings).
    int32_t ring_id = -1;
    int next_peer = -1, prev_peer = -1;
    std::vector<int64_t>* seq = nullptr;
  };

  struct ExecCtx {
    int channel = 0;
    int nchannels = 1;
    // Non-null when this response is one slice of a concurrent wave:
    // an allreduce slice writes its wall time here instead of adding it
    // to allreduce_ns_, and ExecuteResponses accounts the MAX across
    // the wave's slices once — thread-summing would inflate
    // allreduce_ns by the concurrency factor, and charging the whole
    // wave's wall would pollute it with co-scheduled non-allreduce
    // responses; either way the derived bus bandwidth would lie.
    int64_t* wave_allreduce_wall_ns = nullptr;
  };
  // Execute one cycle's agreed responses.  Flat-ring worlds with
  // multiple channels run independent responses concurrently in waves of
  // num_channels_ (assignment by list index — identical on every rank,
  // so cross-rank wire order stays deterministic); everything else
  // (C == 1, hierarchical, single response) executes serially with the
  // full channel range.
  void ExecuteResponses(std::vector<Response>& responses);
  void PerformResponse(const Response& response, const ExecCtx& ctx);
  void ExecAllreduce(const Response& response,
                     std::vector<TensorTableEntry>& entries,
                     const ExecCtx& ctx);
  // The allreduce cascade's path selection over a staged buffer
  // (two-level -> star fold -> quantized/channeled flat ring), shared
  // VERBATIM by ExecAllreduce and ExecReducescatter's exact-parity
  // fallback — one selection, so the fallback's bitwise anchor
  // (reducescatter == allreduce sliced) can never drift from the real
  // allreduce's path choice.  `small` is the caller-evaluated
  // UseSmallAlgo verdict (it depends on the staged byte count);
  // `op_label` names the collective in transport errors.
  bool RunAllreduceCascade(uint8_t* exec_buf, int64_t total,
                           DataType exec_dtype, ReduceOp op,
                           WireDtype wire, bool quantized, bool half_wire,
                           bool small, const char* op_label,
                           const std::string& tname, const ExecCtx& ctx,
                           std::string* msg);
  void ExecAllgather(const Response& response,
                     std::vector<TensorTableEntry>& entries,
                     const ExecCtx& ctx);
  void ExecBroadcast(const Response& response,
                     std::vector<TensorTableEntry>& entries,
                     const ExecCtx& ctx);
  void ExecReducescatter(const Response& response,
                         std::vector<TensorTableEntry>& entries,
                         const ExecCtx& ctx);
  void ExecAlltoall(const Response& response,
                    std::vector<TensorTableEntry>& entries,
                    const ExecCtx& ctx);
  // Ring allreduce sharded across the ctx's channels of the given ring
  // (flat TCP, flat shm, intra-host shm, or the leader cross ring).
  // Channel shards slice WITHIN each ring segment (never re-segment the
  // raw element range), so an element's segment id — and therefore the
  // rank order its reduction applies in — is independent of the channel
  // count AND the transport: results are bit-identical for any fan-out,
  // 1..N, shm or TCP.
  // `rs_only` stops the cascade after the reduce-scatter half: with the
  // caller's spec.vrank pre-rotated by -1, this rank ends owning ring
  // segment `vrank+1` fully reduced — bits identical to the full
  // allreduce's value of that segment (the allgather half moves bytes
  // verbatim, it never changes them).
  bool ChanneledRingAllreduce(uint8_t* base, int64_t count, DataType dtype,
                              ReduceOp op, const RingSpec& spec,
                              const ExecCtx& ctx, const std::string& tname,
                              std::string* err, bool rs_only = false);
  // One channel's chunk-pipelined ring phases over explicit per-segment
  // counts/offsets (absolute element offsets into `base`).
  bool RingReduceScatterPhaseCh(uint8_t* base,
                                const std::vector<int64_t>& seg_count,
                                const std::vector<int64_t>& seg_off,
                                DataType dtype, ReduceOp op,
                                const RingSpec& spec, int ch,
                                std::string* err);
  bool RingAllgatherPhaseCh(uint8_t* base,
                            const std::vector<int64_t>& seg_count,
                            const std::vector<int64_t>& seg_off,
                            size_t esize, const RingSpec& spec, int ch,
                            std::string* err);
  // A set of channels' ENTIRE allreduces (reduce-scatter + allgather),
  // each a chunk-granular streaming cascade, multiplexed in ONE poll
  // loop: the send of chunk k at step s+1 becomes eligible the moment
  // chunk k of step s is received (and, in the reduce-scatter half,
  // reduced) — no per-step barrier anywhere, so a scheduling hiccup on
  // one rank costs one chunk of pipeline depth, not a whole segment
  // round — and one driver thread services whichever channel has work,
  // so channel fan-out never forces thread fan-out (decisive on small
  // hosts; big hosts split channels across pool drivers).  Values are
  // bit-identical to the stepped phases: same segments, same reduction
  // order per element; chunk edges only change WHEN a reduction runs,
  // never what it computes.  Per-channel segment tables are indexed
  // [channel][segment] with absolute element offsets into `base`.
  struct ChannelSegs {
    int ch = 0;  // global channel id (port index in the spec)
    std::vector<int64_t> seg_count, seg_off;
  };
  bool StreamingRingChannels(uint8_t* base,
                             const std::vector<ChannelSegs>& channels,
                             DataType dtype, ReduceOp op,
                             const RingSpec& spec, const std::string& tname,
                             std::string* err, bool rs_only = false);
  // Star-shaped shard delivery down the shm star: the leader (group
  // position 0), holding the fully reduced buffer, sends each member
  // exactly its owned slice [shard_off[m], shard_off[m]+shard_count[m])
  // (absolute element offsets into `base`, indexed by GROUP position) —
  // the scatter twin of StarBroadcast, and lossless by construction, so
  // slicing preserves the fold's bits for ANY shard geometry.
  bool StarScatterShards(uint8_t* base,
                         const std::vector<int64_t>& shard_count,
                         const std::vector<int64_t>& shard_off,
                         size_t esize, std::string* err);
  // Compressed-wire allreduce over `spec`: quantize the fp32 payload
  // into the wire representation (fp16/bf16 halves, or int8/fp8 scaled
  // blocks), run the SAME channel-sharded streaming ring over the wire
  // buffer, dequantize back.  Deterministic for a fixed world (RNE
  // quantization, fixed ring schedule); per-hop requantization makes it
  // value-lossy by design — convergence tests, not bitwise ones.
  bool CompressedRingAllreduce(uint8_t* base, int64_t count,
                               WireDtype wire, ReduceOp op,
                               RingSpec spec, const ExecCtx& ctx,
                               const std::string& tname, std::string* err);
  // The codec's reduction kernel: dequantize both blocks, combine in
  // fp32, rescale + requantize into dst.  Timed into reduce_ns_.
  void WireReduceBlocksTimed(uint8_t* dst, const uint8_t* src,
                             int64_t nblocks, const WireCodec& codec,
                             ReduceOp op);
  // ReduceInto + reduce_ns accounting; splits reductions at or above
  // max(2 MB, 2x the pipeline chunk) across idle pool workers (disjoint
  // element ranges — bit-equal to serial; pipeline-chunk reduces stay
  // serial because they already overlap the wire).
  void ReduceIntoTimed(void* dst, const void* src, int64_t count,
                       DataType dtype, ReduceOp op);
  // Free the fusion scratch high-water allocations (idle for a while, or
  // teardown); cheap no-op when nothing is held.
  void ReleaseScratch();
  void MaybeReleaseScratch();
  // `participants` < 0 = full world (size_); partial commits pass the
  // committed participant count; skipped entries pass 0.
  void FinishEntry(TensorTableEntry& e, const Status& s,
                   int participants = -1);
  void CheckForStalledTensors();
  void CloseSockets();
  // "rank N disconnected during allreduce of 'x': detail" — maps a
  // SendRecvAll error (prefixed send/recv) to the guilty neighbor rank.
  std::string TransportError(const std::string& op, const std::string& name,
                             const std::string& detail, int next_rank,
                             int prev_rank) const;

  std::shared_ptr<HandleState> GetHandle(int64_t handle);

  // -- identity / lifecycle --
  std::atomic<bool> initialized_{false};
  std::atomic<bool> shut_down_{false};
  std::atomic<bool> shutdown_requested_{false};
  int rank_ = 0, size_ = 1, local_rank_ = 0, local_size_ = 1;
  std::string last_error_;
  std::thread background_;

  // -- knobs (reference operations.h:53-58 env vars) --
  // The four LIVE-TUNABLE knobs (cycle_time_ms_, fusion_threshold_,
  // chunk_bytes_ below, wave_width_ below) are atomics: the online
  // autotuner rewrites them between negotiation cycles (ApplyTune, on
  // the background thread) while API threads read them for
  // stats()["config"].  Execution reads happen-after the apply via the
  // cycle structure (a TUNE lands only when no responses are in
  // flight), so relaxed loads are sufficient everywhere.
  //
  // Upper bound on a negotiation cycle's idle wait, NOT a floor: the
  // background loop waits on cycle_cv_ and wakes immediately when work
  // is enqueued (or shutdown/fault is requested), so single-tensor
  // latency is bounded by the control round trip, not by this knob.
  std::atomic<int> cycle_time_ms_{5};
  // HOROVOD_CACHE_CAPACITY: max live negotiation-cache slots (0 disables
  // the cache entirely — every cycle uses the full-Request path).
  int64_t cache_capacity_ = 1024;
  bool cache_enabled_ = false;               // capacity > 0 && size > 1
  std::atomic<int64_t> fusion_threshold_{64 * 1024 * 1024};
  bool stall_check_disabled_ = false;
  int stall_warning_sec_ = 60;
  // No-progress bound for any single transport operation
  // (HOROVOD_SOCKET_TIMEOUT_SEC; 0 disables).  A hung-but-connected peer
  // fails collectives with a descriptive error instead of blocking forever.
  int socket_timeout_sec_ = 120;
  // Idle-round allowance for control-plane frames, derived from
  // HOROVOD_CONTROL_PATIENCE_SEC (absolute, world-size independent).
  int control_patience_rounds_ = 5;
  // Worker-side allowance while waiting on the coordinator's response
  // frame: strictly MORE than the coordinator's, because the coordinator
  // is the failure detector — when another rank wedges, the coordinator
  // must exhaust its own patience and broadcast the abort (naming the
  // culprit) BEFORE an idle worker gives up and can only self-diagnose a
  // generic "lost the coordinator".
  int worker_patience_rounds_ = 11;
  // HOROVOD_FAULT_TIMEOUT_SEC (0 = off): hard bound on the time between a
  // rank dying/hanging and every survivor's HorovodInternalError.  When
  // set it caps both the per-transfer socket timeout and the control-plane
  // patience, so detection never waits out the (much longer) production
  // defaults.
  int fault_timeout_sec_ = 0;

  // -- elastic membership (HOROVOD_ELASTIC=1) --
  // Persistent launch identity: the rank passed to Init (stable across
  // re-inits and supervisor relaunches) is the worker id; committed ranks
  // are assigned per-epoch by the coordinator, contiguous over survivors.
  int worker_id_ = 0;
  // The job's launch-time world size (the env identity); an elastic
  // commit may set size_ below it (shrink) or back up to it (rejoin).
  int world_size_ = 1;
  bool elastic_enabled_ = false;
  int min_size_ = 1;               // HOROVOD_ELASTIC_MIN_SIZE
  int grow_timeout_sec_ = 30;      // HOROVOD_ELASTIC_GROW_TIMEOUT_SEC
  // First-rendezvous deadline (coordinator full-house wait and a worker's
  // whole join+assign exchange), HOROVOD_RENDEZVOUS_TIMEOUT_SEC.
  int rendezvous_timeout_sec_ = 120;
  // Committed membership epoch; survives re-Init (a process keeps its
  // history across engine incarnations) but NOT process relaunch — a
  // fresh replacement adopts the coordinator's epoch at join.
  std::atomic<int64_t> epoch_{0};

  // -- deterministic fault injection (HOROVOD_FAULT_INJECT=rank:step:kind;
  //    kinds: exit | hang | drop-conn).  Armed at Init when rank matches;
  //    fires on the `step`-th Enqueue on this rank (0-based, counting every
  //    collective).  `exit` dies in the enqueueing thread; `hang` freezes
  //    the background loop (control frames stop, the process stays alive);
  //    `drop-conn` makes the background loop close every connection and
  //    abort locally without any shutdown handshake. --
  // stale-epoch: the worker prefixes its next control frame with a
  // duplicate stamped epoch-1 (a dead incarnation's delayed message) so
  // tests can assert the coordinator's structural rejection path.
  // slow: rank:step:slow:ms — a deterministic enqueue delay in the API
  // thread (the background loop keeps heartbeating: a STRAGGLER, not a
  // wedge).  step may be '*' (every enqueue, recurring) so chaos
  // schedules can make a rank permanently slow without killing it.
  // conn-reset: rank:step:conn-reset[:prev] — the rank SHUTDOWN(2)s one
  // of its own data-channel sockets the next time a streaming cascade has
  // moved bytes (send side by default; `prev` shoots the recv side, which
  // discards buffered inbound bytes — the realistic lost-data case the
  // RESUME rewind must repair).  step '*' with a numeric 4th field K
  // re-arms every K-th enqueue (a deterministic flap schedule).
  // recv-stall: rank:step:recv-stall:ms — the next cascade stops draining
  // one channel for ms (a transient network/scheduling stall, NOT a dead
  // link: progress resumes by itself and healing must not reconnect).
  enum class FaultKind {
    NONE, EXIT, HANG, DROP_CONN, STALE_EPOCH, SLOW, CONN_RESET, RECV_STALL
  };
  FaultKind fault_kind_ = FaultKind::NONE;
  int64_t fault_step_ = -1;     // -2: every step ('*')
  int64_t fault_slow_ms_ = 0;
  int64_t fault_reset_period_ = 1;   // conn-reset '*': every K-th enqueue
  bool fault_reset_prev_ = false;    // shoot the recv-side socket instead
  int64_t fault_stall_len_ms_ = 200;
  // Armed by MaybeInjectFault (API thread), consumed by the next GLOBAL-
  // ring streaming cascade (background/pool thread).
  std::atomic<bool> fault_conn_reset_{false};
  std::atomic<int64_t> fault_stall_ms_{0};
  // Survives re-Init: an injected fault fires once per process, so an
  // in-process elastic recovery (shutdown + init with the env var still
  // set) does not re-fire it on every incarnation.
  bool fault_fired_ = false;
  std::atomic<int64_t> enqueue_count_{0};
  std::atomic<bool> fault_hang_{false};
  std::atomic<bool> fault_drop_{false};
  std::atomic<bool> fault_stale_epoch_{false};
  void MaybeInjectFault();

  // Why the background loop aborted (set by the background thread before
  // RunLoopOnce returns false on a transport failure, read by it right
  // after — single-thread access, no lock needed).
  std::string abort_reason_;

  // -- pending work (guarded by mu_) --
  std::mutex mu_;
  std::unordered_map<std::string, TensorTableEntry> tensor_table_;
  std::deque<Request> message_queue_;
  // Wakes the background loop the moment work arrives (Enqueue) or
  // shutdown/fault is requested; RunLoopOnce waits on it with
  // cycle_time_ms_ as the idle-heartbeat upper bound.
  std::condition_variable cycle_cv_;

  // -- handles --
  std::mutex handle_mu_;
  std::unordered_map<int64_t, std::shared_ptr<HandleState>> handles_;
  std::condition_variable handle_cv_;
  std::atomic<int64_t> next_handle_{0};

  // -- coordinator state (rank 0 only; background-thread-only, NOT mu_) --
  struct PendingInfo {
    std::vector<Request> requests;        // one per reporting rank
    std::vector<bool> seen;               // which ranks reported
    // Per-rank arrival times: partial-commit grace is measured from
    // QUORUM formation (the (nvoters-k)-th voter's arrival), not from
    // the first request — an early-bird rank (e.g. a one-shot
    // straggler catching up ahead of peers sleeping out its skip) must
    // not burn the grace budget for everyone else.
    std::vector<std::chrono::steady_clock::time_point> seen_time;
    int count = 0;
    std::chrono::steady_clock::time_point first_seen;
  };
  // Owned exclusively by the background thread (RunLoopOnce and the
  // functions it calls: CoordinatorStep, BuildResponse,
  // CheckForStalledTensors).  Not guarded by mu_ — never touch it from
  // an API thread; AssertBackgroundThread() makes the invariant
  // self-checking at every access site.
  std::unordered_map<std::string, PendingInfo> message_table_;
  std::atomic<std::thread::id> bg_thread_id_{};
  void AssertBackgroundThread() const;
  std::chrono::steady_clock::time_point last_stall_check_;

  // -- negotiation response cache (background-thread-only, like
  //    message_table_; every access site is AssertBackgroundThread-
  //    checked via its callers).
  //
  // Every rank keeps an identical replica: slot → (signature, the
  // single-tensor Response negotiated for it).  The coordinator is the
  // only writer of slot ASSIGNMENTS (broadcast via Response::cache_slots)
  // and EVICTIONS (ResponseList::evict_slots), so the replicas stay in
  // lockstep with the wire protocol's one-frame-per-cycle cadence. --
  struct CacheSignature {
    RequestType type = RequestType::ALLREDUCE;
    DataType dtype = DataType::FLOAT32;
    int32_t root_rank = -1;
    ReduceOp red_op = ReduceOp::SUM;
    // Wire dtype is part of the signature: a live retune of the wire
    // knob changes new requests' signatures, evicting the slot and
    // renegotiating — a cached response can never replay a stale wire
    // format.
    WireDtype wire_dtype = WireDtype::FP32;
    // Priority is signature-relevant too: a priority change must evict
    // and renegotiate so cached-slot replay always orders (and
    // band-fuses) by the CURRENT priority on every rank.
    int32_t priority = 0;
    std::vector<int64_t> shape;
    // Alltoall split geometry: a split change re-routes bytes, so it
    // must evict and renegotiate exactly like a shape change.
    std::vector<int64_t> splits;
    bool Matches(const Request& q) const {
      return q.type == type && q.dtype == dtype && q.root_rank == root_rank &&
             q.red_op == red_op && q.wire_dtype == wire_dtype &&
             q.priority == priority && q.shape == shape &&
             q.splits == splits;
    }
  };
  struct CacheEntry {
    CacheSignature sig;
    Response response;    // single-tensor, ready to execute/fuse
  };
  std::unordered_map<std::string, uint32_t> cache_by_name_;
  std::unordered_map<uint32_t, CacheEntry> cache_entries_;
  // Slots whose hit bit we sent but whose cached response has not fired
  // yet (tensor still in tensor_table_); on an evict broadcast these
  // convert back to full Requests so nothing strands.
  std::unordered_map<uint32_t, std::string> pending_cache_hits_;
  std::vector<Request> cache_resubmits_;     // forced-full after evicts

  // Coordinator-only readiness bits per slot (the cached analogue of
  // PendingInfo) plus the slot allocator.  Freed slot ids are reused
  // smallest-first so ids stay < capacity and hit bitvectors stay tiny.
  struct SlotPending {
    std::vector<bool> seen;
    // Per-voter arrival times (see PendingInfo::seen_time: quorum-based
    // partial-commit grace).
    std::vector<std::chrono::steady_clock::time_point> seen_time;
    int count = 0;
    std::chrono::steady_clock::time_point first_seen;
  };
  std::unordered_map<uint32_t, SlotPending> coord_slot_bits_;
  std::unordered_map<uint32_t, std::string> coord_slot_names_;
  std::unordered_map<std::string, uint32_t> coord_slot_by_name_;
  std::set<uint32_t> free_slots_;
  uint32_t next_slot_ = 0;

  // -- backup-worker straggler tolerance --
  // Committed over-provisioning: the coordinator's env resolution rides
  // the ASSIGN frame (like the channel count) so stats agree everywhere;
  // the per-cycle participant bitmaps are what actually drive behavior.
  // 0 = fully synchronous, bit-for-bit the pre-backup engine.
  int backup_workers_ = 0;
  // Minimum pending age before a partial commit may fire
  // (HOROVOD_BACKUP_GRACE_MS): sub-cycle enqueue jitter between healthy
  // ranks must never be mistaken for straggling — only a rank late by
  // more than the grace gets skipped.
  int backup_grace_ms_ = 50;
  // HOROVOD_BACKUP_WORKERS=auto: k stays 0 until the coordinator's own
  // step-time window turns pathological (p99 > ratio · p50 with enough
  // samples), then partial commits arm at k=1 for as long as the ratio
  // stays above threshold.  Coordinator-local: workers never need k —
  // every commit decision reaches them inside a response.
  bool backup_auto_ = false;
  double backup_auto_ratio_ = 3.0;
  std::atomic<bool> backup_armed_{false};
  // name → outstanding skip tokens (background-thread-only, like
  // message_table_): a partial commit that excluded this rank BEFORE it
  // enqueued the tensor banks a token here; the future enqueue consumes
  // it and finishes "skipped" locally instead of shipping a stale
  // request the coordinator no longer expects.
  std::unordered_map<std::string, int> skip_tokens_;
  // Sliding window of allreduce completion latencies (enqueue→finish)
  // for the step_time_ns percentiles; own lock — FinishEntry runs on
  // the background thread, readers are API threads.
  mutable std::mutex step_ns_mu_;
  std::vector<int64_t> step_ns_samples_;
  size_t step_ns_next_ = 0;

  // -- fleet telemetry (see the public accessors above) --
  // Per-rank send side (background thread only): cycle cadence counter
  // and the last-sent absolute counter snapshot the deltas derive from.
  // telem_last_ survives re-Init on purpose — deltas stay exact across
  // an elastic recovery because they are differences of process-
  // cumulative counters.
  int64_t telemetry_cycles_ = 50;
  int64_t telem_cycle_count_ = 0;
  int64_t telem_last_[TC_COUNT] = {0};
  std::atomic<int64_t> telem_bytes_tx_{0};
  std::atomic<int64_t> stall_warnings_{0};
  // Attach this rank's TELEM entry to the outgoing RequestList when the
  // cadence (or `force` — the shutdown frame) says so.
  void MaybeAttachTelem(RequestList* list, bool force);
  TelemEntry BuildTelemEntry();
  // Rank-0 fleet table: one row per reporting entry (per rank on the
  // flat control plane, per host group under hierarchical coordination).
  // Own mutex: the background thread absorbs, API/monitor threads read.
  struct FleetRow {
    int32_t nranks = 0;
    int32_t host = 0;
    int64_t counters[TC_COUNT] = {0};
    int64_t step_p50 = 0, step_p99 = 0;
    int32_t slow_rank = -1;
    int64_t slow_p99 = 0;
    int64_t updates = 0;
    int64_t last_update_mono_ns = 0;
  };
  mutable std::mutex fleet_mu_;
  std::map<int32_t, FleetRow> fleet_rows_;
  // Rank-granular quorum-lag attribution (commits whose LAST voter was
  // this rank, and its worst lag).  Separate from fleet_rows_ — rows
  // are per-host under hierarchical coordination while attribution
  // stays per rank.  Guarded by fleet_mu_ with the rows.
  struct QuorumAttr {
    int64_t count = 0;
    int64_t max_ns = 0;
  };
  std::map<int32_t, QuorumAttr> quorum_attr_;
  void FleetAbsorb(const TelemEntry& t);
  // Coordinator quorum-lag window (lag of the last voter behind the
  // second-to-last, per committed entry) + per-rank attribution into
  // the fleet rows.  voter_ranks parallel to voter_times.
  void NoteQuorumLag(
      const std::vector<std::chrono::steady_clock::time_point>& times,
      const std::vector<int>& voter_ranks);
  // Synthetic lag sample recorded when a partial commit fires: the
  // skipped voter trails the quorum by at least the time the quorum has
  // been waiting (>= the grace window by construction).  Keeps the
  // arming window saturated while skips are actively occurring —
  // without it, post-arming entries commit WITHOUT the straggler and
  // stop producing lag samples, so the armed verdict would decay and
  // oscillate on window churn.
  void NoteSkippedQuorumLag(int64_t lag_ns);
  int64_t QuorumLagNsPercentile(double p) const;
  mutable std::mutex quorum_mu_;
  std::vector<int64_t> quorum_lag_samples_;
  size_t quorum_lag_next_ = 0;
  int backup_auto_rule_ = 0;       // 0 = quorum (default), 1 = steptime
  // Rendezvous clock sync + flight recorder plumbing.
  int64_t clock_offset_ns_ = 0;
  int64_t control_cycle_seq_ = 0;  // background thread only
  // Per-tensor stall-warning rate limit + one-shot escalation dump.
  std::unordered_map<std::string,
                     std::chrono::steady_clock::time_point>
      stall_last_warned_;
  bool flight_escalated_ = false;

  // -- hierarchical coordination state --
  // Committed flag (coordinator env resolution broadcast in the ASSIGN
  // frame; active only when the topology has >1 group and >1 rank in
  // some group — see HierActive).  =0 restores the flat rank-0 star
  // bit-for-bit.
  bool hier_coord_ = false;
  // Member ↔ leader control connections, wired next to the data rings
  // with the same (origin, ring=CTRL, channel, epoch) handshake: a
  // member holds ONE conn to its group leader; a leader holds one per
  // member, indexed by group position ([0] = itself, unused).
  Socket leader_conn_;                 // member → group leader
  std::vector<Socket> member_conns_;   // leader side, by group position
  // Leader-held partial readiness per cache slot (background-thread-
  // only, like coord_slot_bits_): seen is indexed by GROUP POSITION;
  // the slot's bit goes up to rank 0 only when count == group_size_.
  // Bits for slots evicted by a relayed response are dropped — a stale
  // held bit forwarded after a slot's reassignment would count a false
  // group grant for the new tensor.
  struct SubSlotPending {
    std::vector<bool> seen;
    int count = 0;
    std::chrono::steady_clock::time_point first_seen;
  };
  std::unordered_map<uint32_t, SubSlotPending> sub_slot_bits_;
  // Leader-side stall warning over the held partial bits: a slot whose
  // group never completes would otherwise stall SILENTLY — the leader
  // forwards nothing, so rank 0's detector has count == 0 and prints
  // nothing.  Named after the missing MEMBER ranks, same cadence as
  // CheckForStalledTensors.
  void CheckForStalledSubBits();
  std::chrono::steady_clock::time_point last_sub_stall_check_;

  // -- network --
  Socket control_listener_;                // rank 0
  std::vector<Socket> worker_conns_;       // rank 0: [size-1] control conns
  Socket coordinator_conn_;                // rank != 0
  // Data-plane neighbors (global ring), one independent socket pair per
  // channel (HOROVOD_NUM_CHANNELS; the committed count is broadcast in
  // the rendezvous ASSIGN so every rank wires the same fan-out, and the
  // channel handshake is epoch-stamped so an elastic re-rendezvous
  // rewires every channel of the new incarnation only).
  std::vector<Socket> ring_next_, ring_prev_;
  Socket data_listener_;

  // -- host topology + shared-memory transport (the second channel kind) --
  //
  // The coordinator groups ranks by HOST KEY at rendezvous (HOROVOD_HOST_KEY
  // override, else hostname#boot-id from the JOIN frame) and broadcasts the
  // grouping in the ASSIGN frame.  Co-located ranks wire mmap ring-buffer
  // edges (shm.h) instead of pushing bytes through the loopback TCP ring:
  //   * single host (or any host group spanning the whole world): the flat
  //     ring allreduce runs over shm edges — same algorithm, same segments,
  //     same fold order as the TCP path, so results are BIT-IDENTICAL with
  //     shm on or off;
  //   * multiple hosts with co-located ranks: collectives go two-level —
  //     intra-host ring reduce-scatter over shm, one leader per host in the
  //     inter-host TCP ring (num_channels_-wide), intra-host broadcast back
  //     (the reference's NCCL-reduce → cross-node MPI → NCCL-broadcast
  //     decomposition, operations.cc:1025-1187, generalized from the eager
  //     HOROVOD_HIERARCHICAL_ALLREDUCE into the native engine).  A
  //     different topology is a different (deterministic) reduction order;
  //     within one topology, transport and channel count never change bits.
  // HOROVOD_SHM_DISABLE=1 (or an unavailable /dev/shm, probed on the
  // coordinator) turns all of this off and restores the flat TCP path
  // exactly; the COMMITTED flag is broadcast so every rank agrees.
  bool shm_enabled_ = true;
  bool two_level_ = false;                 // committed: H > 1 and max L > 1
  int node_id_ = 0, nnodes_ = 1;           // my host group id, host count
  std::vector<int32_t> rank_host_;         // committed group id per rank
  std::vector<int> group_members_;         // my group's ranks, ascending
  std::vector<int> group_leaders_;         // first (lowest) rank per group
  int local_index_ = 0;                    // my index in group_members_
  int group_size_ = 1;
  bool shm_ring_active_ = false;           // intra-group shm edges wired
  std::string shm_prefix_;                 // /dev/shm name prefix (job tag)
  // Derive node_id_/group_members_/leaders from the committed rank_host_.
  void AdoptTopology();
  // Create/attach the group's shm edges (ring rings per channel + star
  // edges to the leader), then unlink-after-map.  Bounded by the
  // rendezvous timeout; a peer death mid-wiring surfaces as a clean
  // init error.
  bool WireShmEdges(std::string* err);
  // Intra-group cyclic ring, one ring per direction per channel:
  // shm_ring_tx_[c] carries my bytes toward ring-next, shm_ring_rx_[c]
  // receives from ring-prev (matching the TCP plane, where collectives
  // only ever send next / recv prev).  shm_star_ holds the duplex edges
  // to the group leader (members: [0] = to-leader; the leader: one per
  // member, indexed by group position, [0] unused) — they carry the
  // small-tensor star algorithm, the two-level segment gather, and the
  // result broadcast.
  std::vector<ShmRing> shm_ring_tx_, shm_ring_rx_;
  std::vector<ShmEdge> shm_star_;
  // Leader-only inter-host ring, one socket pair per channel.
  std::vector<Socket> cross_next_, cross_prev_;
  void CloseShmEdges();
  void CountShmBytes(int64_t tx, int64_t rx);

  RingSpec TcpRingSpec();              // whole world over the TCP ring
  RingSpec ShmRingSpec();              // my host group over shm rings
  RingSpec CrossRingSpec();            // leaders over TCP
  // The flat ring collectives actually run on: the shm ring when one host
  // group spans the whole committed world (and shm is wired), the TCP
  // ring otherwise.  Identical vrank/rsize either way, so transport can
  // never change segment arithmetic — only the bytes' route.
  RingSpec FlatRingSpec();
  // Count payload bytes moved on a port (data_bytes_* always; the shm/
  // intra-host counters when the port is an shm edge; compressed_bytes_tx
  // when the bytes are wire-compressed payload).
  void CountPortBytes(const RingPort& port, int64_t tx, int64_t rx,
                      bool compressed = false);
  // Transport-generic primitives on one ring port (TCP socket pair or shm
  // edge) — the phase/relay code calls these and never branches on the
  // channel kind itself.  `patience_rounds` scales the shm no-progress
  // bound exactly like RecvAllPatient's socket-timeout rounds.
  static bool PortSendRecvChunked(
      const RingPort& port, const void* send_buf, size_t sn, void* recv_buf,
      size_t rn, size_t chunk,
      const std::function<void(size_t, size_t)>& on_chunk, int timeout_ms,
      std::string* err, int64_t* wire_ns);
  bool PortSendAll(const RingPort& port, const void* p, size_t n,
                   std::string* err);
  bool PortRecvAllPatient(const RingPort& port, void* p, size_t n,
                          int patience_rounds, std::string* err);

  // Two-level allreduce over the committed topology (see above): intra
  // ring reduce-scatter (or the star fold under the small-tensor algo) →
  // segment gather to the leader → leader ring across hosts → star
  // broadcast back down.  Deterministic per topology; value-independent
  // of transport, channels, and the algo threshold (the star emulates the
  // ring's exact per-segment fold order).
  // `wire`: INT8/FP8 compress ONLY the leader cross-host ring (the hop
  // that crosses a real network); the intra-host shm phases stay at the
  // buffer's dtype.  fp16/bf16 wires never reach here as `wire` —
  // ExecAllreduce stages the whole collective to a half buffer first
  // and passes `compressed_payload` so the ring phases still account
  // the bytes into compressed_bytes_tx.
  bool TwoLevelAllreduce(uint8_t* base, int64_t count, DataType dtype,
                         ReduceOp op, const std::string& name,
                         const ExecCtx& ctx, WireDtype wire,
                         bool compressed_payload, std::string* err);
  // Two-level REDUCE-SCATTER (the RS half of the hierarchy, used only
  // when the committed shard geometry is host-block-aligned — see
  // ExecReducescatter): the intra-host phase runs VERBATIM from
  // TwoLevelAllreduce (same fold, same bits, leader ends holding the
  // full host sum), the leader cross-host ring stops after its
  // reduce-scatter half (leader h ends owning exactly its members'
  // shard block), and the members get their own shards via
  // StarScatterShards instead of the full star broadcast — cross wire
  // and down-link both halve.  shard_count/off are absolute element
  // offsets of the committed per-RANK shards (world-indexed).
  bool TwoLevelReduceScatter(uint8_t* base, int64_t count, DataType dtype,
                             ReduceOp op,
                             const std::vector<int64_t>& shard_count,
                             const std::vector<int64_t>& shard_off,
                             const std::string& name, const ExecCtx& ctx,
                             bool compressed_payload, std::string* err);
  // Shared intra-host phase of the two-level collectives: host-group
  // reduce (star fold under the small algo, else shm ring RS + segment
  // gather) leaving the LEADER holding the full host sum.  Members'
  // buffers are partially clobbered — the caller owes them a broadcast
  // (allreduce) or their shard (reduce-scatter).
  bool TwoLevelIntraReduce(uint8_t* base, int64_t count, DataType dtype,
                           ReduceOp op, const std::string& name,
                           const ExecCtx& ctx, bool compressed_payload,
                           std::string* err);
  // Star (gather→fold→broadcast) allreduce within the host group: every
  // member ships its buffer to the leader over shm, the leader reproduces
  // the ring reduce-scatter's per-segment fold ORDER exactly (same
  // ReduceInto kernel, same operand order, same EvenSegments boundaries —
  // the algo switch can therefore never change a bit), and — when
  // `broadcast_result` — ships the folded buffer back.  2 shm hops of
  // latency instead of 2(L-1) ring steps: the small-tensor path.
  bool StarFoldAllreduce(uint8_t* base, int64_t count, DataType dtype,
                         ReduceOp op, bool broadcast_result,
                         std::string* err);
  // Leader → members full-buffer broadcast over the star edges (chunked).
  bool StarBroadcast(uint8_t* base, size_t nbytes, std::string* err);
  // Should this allreduce take the star path?  bytes under the live
  // threshold, star edges wired, and the serial execution context (a
  // concurrent wave slice owns one CHANNEL, not the star edges).
  bool UseSmallAlgo(int64_t nbytes, const ExecCtx& ctx) const;

  // -- data plane: channels / pool / chunking knobs --
  // Committed per-edge channel count.  The env default is auto from core
  // count (1 restores the single-socket path exactly); the coordinator's
  // value is broadcast at rendezvous so all ranks agree.
  int num_channels_ = 1;
  // HOROVOD_SOCKET_BUF_BYTES: SO_SNDBUF/SO_RCVBUF for ring data sockets
  // (0 = kernel default).  Bigger buffers keep the wire moving while
  // userland reduces — the kernel-side half of wire/compute overlap.
  int socket_buf_bytes_ = 0;
  // HOROVOD_CHUNK_BYTES: ring-phase pipeline chunk (recv of chunk k+1
  // overlaps the ReduceInto of chunk k); multiple of 8 so chunk edges
  // align to every dtype.  Live-tunable (see the knobs comment above).
  std::atomic<int64_t> chunk_bytes_{1 << 20};
  // HOROVOD_ALGO_THRESHOLD: size-based algorithm selection (the NCCL
  // tree-vs-ring pattern PAPER.md's L0 layer delegates downward).
  // Allreduces at or under this many payload bytes take the
  // latency-optimized star path when star edges are wired; 0 disables.
  // Live-tunable (committed at rendezvous, retuned via TUNE frames —
  // every rank must agree or the wire patterns split).  Value-neutral by
  // construction: the star reproduces the ring's exact fold order.
  std::atomic<int64_t> algo_threshold_{32 * 1024};
  // HOROVOD_WIRE_DTYPE: default wire format for fp32 allreduce payloads
  // (WireDtype values; live-tunable knob #6).  Per-rank agreement comes
  // from negotiation, not from this knob: every Request carries its
  // resolved wire dtype and the coordinator validates cross-rank, so a
  // heterogeneous env surfaces as a clean error — never a garbled wire.
  std::atomic<int> wire_dtype_{0};
  // HOROVOD_PRIORITY_BANDS: priority band WIDTH (band = priority /
  // width).  0 = off: bit-identical legacy arrival ordering, no wave
  // splitting, no band fusion gate.  > 0: the coordinator orders each
  // cycle's responses by (priority, name), fusion only merges within a
  // band, and waves dispatch in band order.  Committed in the
  // rendezvous ASSIGN (ordering IS the wire pattern) and live-tunable
  // thereafter (knob #7).
  std::atomic<int64_t> priority_bands_{0};
  // Per-band fusion-threshold ladder (HOROVOD_FUSION_LADDER env /
  // autotuner-learned): band b's threshold, 0 = fall back to the global
  // fusion_threshold_.  Bands >= kFusionLadderMax share the last slot.
  std::atomic<int64_t> fusion_ladder_[kFusionLadderMax] = {};
  std::atomic<int64_t> priority_inversions_{0};
  // Resolve a response's scheduling priority on THIS rank: the
  // coordinator stamped resp.priority at build time; workers received
  // the committed NONZERO values in the frame's trailing priority
  // section (absence = committed 0 — never the local entry, whose
  // stamp differs on a probing rank).  -1 = unknown (ghost rides,
  // errors, foreign sparse retries).
  int ResolveResponsePriority(Response& resp);
  int64_t ResponseBand(const Response& resp) const {
    const int64_t width = priority_bands_.load();
    if (width <= 0 || resp.priority < 0) return 0;
    return resp.priority / width;
  }
  // Count dispatch-order priority inversions over one cycle's combined
  // execution list (`first` dispatches before `second`) and fold them
  // into priority_inversions_.
  void CountPriorityInversions(const std::vector<Response>& first,
                               const std::vector<Response>& second);
  // Merge this cycle's cached + fresh responses into ONE dispatch list
  // ordered by (priority, first name) — errors/sparse-retries first
  // (they execute locally, no wire), partial commits last (their
  // priority is unknowable on ghost ranks, so the rule must derive from
  // the response alone).  Only used with priority_bands > 0.
  static void OrderResponsesByPriority(std::vector<Response>& responses);
  // HOROVOD_SHM_RING_BYTES: per-direction shm ring capacity.
  int64_t shm_ring_bytes_ = 2 << 20;
  // Concurrent-response wave width: how many independent responses of
  // one cycle execute at once on disjoint channels (<= num_channels_).
  // The committed value is broadcast in the rendezvous ASSIGN next to
  // the channel count — waves pick channels by response index, so a
  // cross-rank mismatch would pair different responses on the same
  // socket.  Live-tunable thereafter (TUNE frames apply on every rank at
  // the same cycle boundary, which preserves the agreement).
  std::atomic<int> wave_width_{1};
  // HOROVOD_CHANNEL_DRIVERS: how many threads actively drive the channel
  // fan-out of ONE collective (default auto: one per core).  Channels
  // above this count are multiplexed within a driver's poll loop, so
  // adding channels never oversubscribes a small host.
  int channel_drivers_ = 1;
  DataPool pool_;

  // -- link self-healing (HOROVOD_LINK_RETRIES > 0) --
  // A data-channel socket failure mid-cascade (reset/EOF/TCP_USER_TIMEOUT)
  // is classified SUSPECT instead of fatal: the channel's cascade parks at
  // its exact step/offset cursor while the edge's sender re-dials the
  // receiver's data listener with a RESUME hello (capped-backoff loop,
  // at most link_retries_ attempts within link_heal_timeout_ms_) and the
  // receiver ACKs its authoritative cursor so the sender rewinds — the
  // collective then completes bit-identically (resent bytes are re-read
  // from the same buffer positions; the pipeline's credit chain
  // guarantees un-received bytes are never overwritten).  Exhaustion
  // escalates to the UNCHANGED abort path with the original transport
  // error (same culprit attribution).  =0 disables healing entirely —
  // behavior is bit-for-bit the pre-heal engine.  Both knobs are the
  // coordinator's resolution, committed in the ASSIGN frame: a
  // heterogeneous env must not leave one endpoint healing an edge the
  // other already abandoned.
  int link_retries_ = 3;
  int64_t link_heal_timeout_ms_ = 10000;
  // Committed peer table (host:port per rank), kept for mid-run
  // reconnects; refreshed by every rendezvous.
  std::vector<std::string> peer_hosts_;
  std::vector<int> peer_ports_;
  // Per-channel cascade stream sequences (GLOBAL ring / leader CROSS
  // ring).  Each StreamingRingChannels invocation bumps its channels'
  // counters; both endpoints of an edge execute the same deterministic
  // response sequence over the same channels, so the counters agree and
  // a RESUME names exactly one in-flight cascade.  Channel-disjoint
  // writers (wave/driver assignment) — no lock needed.
  std::vector<int64_t> link_seq_global_, link_seq_cross_;
  // Resume connections accepted by a cascade that does not own the named
  // channel (another driver's channel, or a cascade not yet entered):
  // parked here for the owner, which ACKs from its own cursor.  Keyed
  // (ring_id, channel); newest wins.
  std::mutex heal_mu_;
  std::map<std::pair<int32_t, int32_t>, std::pair<LinkResume, Socket>>
      heal_inbox_;
  std::atomic<int> heal_inbox_size_{0};
  std::atomic<int64_t> link_reconnects_{0};
  std::atomic<int64_t> link_heal_failures_{0};
  mutable std::mutex heal_ns_mu_;
  std::vector<int64_t> heal_ns_samples_;
  size_t heal_ns_next_ = 0;
  void RecordLinkHealNs(int64_t ns);
  int64_t LinkHealNsPercentile(double p) const;
  // Deposit an accepted RESUME conn for the owning cascade (newest wins).
  void HealInboxPut(int32_t ring, int32_t channel, const LinkResume& lr,
                    Socket conn);
  // Claim a parked RESUME conn for (ring, channel); invalid Socket when
  // none is parked.
  bool HealInboxTake(int32_t ring, int32_t channel, LinkResume* lr,
                     Socket* conn);
  void HealInboxClear();

  // -- fusion scratch (one slot per channel: a concurrent wave gives each
  //    response its own buffer; slot 0 serves the serial path).  Capped
  //    at HOROVOD_FUSION_THRESHOLD and released after a 2 s idle spell or
  //    at teardown, so the high-water allocation is not retained forever. --
  std::vector<std::vector<uint8_t>> fusion_buffers_;
  std::chrono::steady_clock::time_point last_exec_time_;

  // -- online autotune (TUNE broadcast) --
  // Pending proposal queued by QueueTune (API thread) and drained into
  // the next cycle's ResponseList by the coordinator's background loop.
  struct TuneSpec {
    int64_t trial_id = 0;
    int64_t chunk_bytes = 0;
    int64_t fusion_threshold = 0;
    int32_t cycle_time_ms = 0;
    int32_t wave_width = 0;
    int64_t algo_threshold = -1;  // < 0: leave unchanged (0 is a real value)
    int32_t wire_dtype = -1;      // < 0: leave unchanged (0 = fp32 is real)
    int64_t priority_bands = -1;  // < 0: leave unchanged (0 = bands off)
    std::vector<int64_t> fusion_ladder;  // empty: unchanged; <=0 per band
    bool commit = false;
  };
  std::mutex tune_mu_;
  // Atomic so the cycle gate's wait predicate can see a pending TUNE
  // without taking tune_mu_ under mu_ — QueueTune's notify is only
  // effective because the woken predicate re-checks this flag.
  std::atomic<bool> tune_pending_{false};
  TuneSpec pending_tune_;
  std::atomic<int64_t> tune_trial_seq_{0};
  // Coordinator/background-loop side: move the pending proposal (if
  // any) into the cycle's outgoing ResponseList; returns true when the
  // frame now carries a TUNE.
  bool DrainPendingTune(ResponseList* out);
  // Apply a received (or locally drained, size==1) TUNE between cycles:
  // clamp exactly like Init so every rank lands on identical effective
  // values, bump tune_trials_, and record the trial on the timeline.
  void ApplyTune(const ResponseList& list);

  // -- execution stats --
  std::atomic<int64_t> exec_cycles_{0};
  std::atomic<int64_t> responses_executed_{0};
  std::atomic<int64_t> tensors_executed_{0};
  std::atomic<int64_t> cache_hits_{0};
  std::atomic<int64_t> cache_misses_{0};
  std::atomic<int64_t> cache_evictions_{0};
  std::atomic<int64_t> negotiation_bytes_tx_{0};
  std::atomic<int64_t> negotiation_bytes_rx_{0};
  std::atomic<int64_t> control_round_trips_{0};
  std::atomic<int64_t> stale_epoch_msgs_{0};
  std::atomic<int64_t> assign_bytes_tx_{0};
  // Sliding window of coordinator payload-cycle control times (ns) for
  // the p50/p99 getters; guarded by cycle_ns_mu_ (one lock per cycle on
  // rank 0, read by API threads).
  mutable std::mutex cycle_ns_mu_;
  std::vector<int64_t> cycle_ns_samples_;
  size_t cycle_ns_next_ = 0;
  std::atomic<int64_t> data_bytes_tx_{0};
  std::atomic<int64_t> data_bytes_rx_{0};
  std::atomic<int64_t> reduce_ns_{0};
  std::atomic<int64_t> wire_ns_{0};
  std::atomic<int64_t> allreduce_bytes_{0};
  std::atomic<int64_t> allreduce_ns_{0};
  std::atomic<int64_t> reducescatter_bytes_{0};
  std::atomic<int64_t> reducescatter_ns_{0};
  std::atomic<int64_t> reducescatter_fallback_count_{0};
  std::atomic<int64_t> alltoall_bytes_{0};
  std::atomic<int64_t> alltoall_ns_{0};
  std::atomic<int64_t> moe_tokens_dropped_{0};
  std::atomic<int64_t> sharded_steps_{0};
  std::atomic<int64_t> shm_bytes_tx_{0};
  std::atomic<int64_t> shm_bytes_rx_{0};
  std::atomic<int64_t> intra_host_bytes_{0};
  std::atomic<int64_t> algo_small_count_{0};
  std::atomic<int64_t> algo_ring_count_{0};
  std::atomic<int64_t> tune_trials_{0};
  std::atomic<int64_t> wire_bytes_saved_{0};
  std::atomic<int64_t> compressed_bytes_tx_{0};
  std::atomic<int64_t> quantize_ns_{0};
  std::atomic<int64_t> wire_fp16_count_{0};
  std::atomic<int64_t> wire_bf16_count_{0};
  std::atomic<int64_t> wire_int8_count_{0};
  std::atomic<int64_t> wire_fp8_count_{0};
  std::atomic<int64_t> backup_skips_{0};
  std::atomic<int64_t> local_sgd_syncs_{0};

  // -- timeline --
  Timeline timeline_;
};

// Element-wise combine of src into dst (the data-plane reduction kernel):
// sum/min/max/prod.  f16/bf16 combine via float, like the reference custom
// MPI op (horovod/common/half.cc) but TPU-era: bf16 is first-class.
void ReduceInto(void* dst, const void* src, int64_t count, DataType dtype,
                ReduceOp op);

}  // namespace hvd
