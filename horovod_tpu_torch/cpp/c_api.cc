// C ABI for the native engine, loaded from Python via ctypes.
//
// Surface parity with the reference C API (horovod/common/operations.h:
// 68-118: horovod_init/_shutdown/_rank/_size/_local_rank/_local_size/
// _mpi_threads_supported + EnqueueTensor*), reshaped for ctypes: instead of
// C++ callbacks, enqueue returns an int64 handle polled/waited on from
// Python (the pattern of the reference torch handle manager,
// horovod/torch/handle_manager.{h,cc}).
#include <cstring>

#include "engine.h"

using hvd::DataType;
using hvd::Engine;
using hvd::RequestType;

extern "C" {

int horovod_init(int rank, int size, int local_rank, int local_size,
                 const char* coordinator_addr) {
  return Engine::Get().Init(rank, size, local_rank, local_size,
                            coordinator_addr ? coordinator_addr : "");
}

void horovod_shutdown() { Engine::Get().Shutdown(); }

int horovod_is_initialized() {
  return Engine::Get().initialized() ? 1 : 0;
}

int horovod_rank() { return Engine::Get().rank(); }
int horovod_size() { return Engine::Get().size(); }
int horovod_local_rank() { return Engine::Get().local_rank(); }
int horovod_local_size() { return Engine::Get().local_size(); }

// Committed membership epoch: bumped by every successful rendezvous
// commit; all live members of a world agree on it, and an elastic resize
// increments it (stale-epoch control frames are rejected structurally).
int64_t horovod_epoch() { return Engine::Get().epoch(); }

// No MPI anywhere; the engine's own threading is unconditional.
int horovod_mpi_threads_supported() { return 1; }

const char* horovod_last_error() {
  return Engine::Get().last_error().c_str();
}

// op: 0 = allreduce, 1 = allgather, 2 = broadcast, 3 = reducescatter,
// 4 = alltoall (RequestType values).
// red_op: 0 = sum, 1 = min, 2 = max, 3 = prod (ReduceOp values;
// allreduce/reducescatter only).
// Returns handle >= 0, -1 on duplicate in-flight name, -2 if not running.
int64_t horovod_enqueue(int op, const char* name, int dtype, int ndim,
                        const int64_t* shape, void* data, int root_rank,
                        int red_op) {
  std::vector<int64_t> dims(shape, shape + ndim);
  return Engine::Get().Enqueue(static_cast<RequestType>(op), name,
                               static_cast<DataType>(dtype), dims, data,
                               root_rank, static_cast<hvd::ReduceOp>(red_op));
}

// Like horovod_enqueue with an explicit per-tensor WIRE dtype for the
// allreduce payload: 0 = fp32, 1 = fp16, 2 = bf16, 3 = int8, 4 = fp8
// (WireDtype values); < 0 defers to the live HOROVOD_WIRE_DTYPE knob —
// exactly what horovod_enqueue does.  Only fp32 allreduces compress.
int64_t horovod_enqueue_wire(int op, const char* name, int dtype, int ndim,
                             const int64_t* shape, void* data,
                             int root_rank, int red_op, int wire_dtype) {
  std::vector<int64_t> dims(shape, shape + ndim);
  return Engine::Get().Enqueue(static_cast<RequestType>(op), name,
                               static_cast<DataType>(dtype), dims, data,
                               root_rank, static_cast<hvd::ReduceOp>(red_op),
                               /*probe=*/false, wire_dtype);
}

// Like horovod_enqueue_wire with the full per-tensor scheduling surface:
// `priority` (>= 0; 0 = most urgent, the default) is the metadata the
// priority-banded coordinator orders responses by (frontends stamp it
// from registration order), and `wire_advisory` != 0 marks the explicit
// wire_dtype as knob-like (the coordinator commits the first value on a
// cross-rank disagreement instead of erroring — the seam the
// statistics-driven wire policy rides, since per-rank gradient stats may
// legitimately disagree for a step).
int64_t horovod_enqueue_priority(int op, const char* name, int dtype,
                                 int ndim, const int64_t* shape, void* data,
                                 int root_rank, int red_op, int wire_dtype,
                                 int wire_advisory, int priority) {
  std::vector<int64_t> dims(shape, shape + ndim);
  return Engine::Get().Enqueue(static_cast<RequestType>(op), name,
                               static_cast<DataType>(dtype), dims, data,
                               root_rank, static_cast<hvd::ReduceOp>(red_op),
                               /*probe=*/false, wire_dtype, priority,
                               wire_advisory != 0);
}

// Layout-probe allreduce (sum) for a tensor whose gradient never
// materialized locally: completes as a normal dense allreduce unless peers
// are gathering the tensor sparsely, in which case the handle fails with
// "__sparse_retry__:<sparse_dim>" and the caller re-enqueues zero-entry
// sparse gathers (see Request::probe in message.h).
int64_t horovod_enqueue_probe(const char* name, int dtype, int ndim,
                              const int64_t* shape, void* data) {
  std::vector<int64_t> dims(shape, shape + ndim);
  return Engine::Get().Enqueue(RequestType::ALLREDUCE, name,
                               static_cast<DataType>(dtype), dims, data,
                               /*root_rank=*/-1, hvd::ReduceOp::SUM,
                               /*probe=*/true);
}

// Execution stats: negotiation cycles that executed work, responses
// executed (a fused batch counts once), and tensors executed.  Lets
// frontends and tests assert the async+fusion property (N tensors batched
// into ~1 cycle, tensors/responses > 1) instead of trusting it.
int64_t horovod_exec_cycles() { return Engine::Get().exec_cycles(); }
int64_t horovod_responses_executed() {
  return Engine::Get().responses_executed();
}
int64_t horovod_tensors_executed() {
  return Engine::Get().tensors_executed();
}

// Control-plane / response-cache observability (see Engine accessors):
// cache hit/miss/eviction counts, control-frame bytes each way, and the
// number of completed coordinator round trips — bench and tests divide
// the last by step count to prove steady state needs ~1 round trip/step.
int64_t horovod_cache_hits() { return Engine::Get().cache_hits(); }
int64_t horovod_cache_misses() { return Engine::Get().cache_misses(); }
int64_t horovod_cache_evictions() {
  return Engine::Get().cache_evictions();
}
int64_t horovod_negotiation_bytes_tx() {
  return Engine::Get().negotiation_bytes_tx();
}
int64_t horovod_negotiation_bytes_rx() {
  return Engine::Get().negotiation_bytes_rx();
}
int64_t horovod_control_round_trips() {
  return Engine::Get().control_round_trips();
}
int64_t horovod_stale_epoch_msgs() {
  return Engine::Get().stale_epoch_msgs();
}

// Big-world control plane: rendezvous ASSIGN bytes this coordinator has
// sent (deterministic, the scale harness's frame-compaction metric), the
// coordinator's control-plane cycle-time percentiles over a sliding
// window of payload cycles (0 on workers / idle worlds), and whether
// hierarchical coordination (per-host sub-coordinators) is committed.
int64_t horovod_assign_bytes_tx() {
  return Engine::Get().assign_bytes_tx();
}
int64_t horovod_coordinator_cycle_ns_p50() {
  return Engine::Get().coordinator_cycle_ns_p50();
}
int64_t horovod_coordinator_cycle_ns_p99() {
  return Engine::Get().coordinator_cycle_ns_p99();
}
int64_t horovod_hier_coordinator() {
  return Engine::Get().hier_coordinator() ? 1 : 0;
}

// Data-plane observability: payload bytes moved over ring data sockets
// (all collectives, all channels), cumulative thread-time split between
// socket progress (wire) and reduction kernels (reduce) — each sums
// ACROSS channels, so either may exceed wall time when channels overlap —
// plus ring-allreduce payload bytes and wall time, from which Python's
// stats() derives allreduce_bus_bw_bytes_per_sec, and the committed
// per-edge channel count.
int64_t horovod_data_bytes_tx() { return Engine::Get().data_bytes_tx(); }
int64_t horovod_data_bytes_rx() { return Engine::Get().data_bytes_rx(); }
int64_t horovod_reduce_ns() { return Engine::Get().reduce_ns(); }
int64_t horovod_wire_ns() { return Engine::Get().wire_ns(); }
int64_t horovod_allreduce_bytes() {
  return Engine::Get().allreduce_bytes();
}
int64_t horovod_allreduce_ns() { return Engine::Get().allreduce_ns(); }
// Reduce-scatter observability (first-class collective + the ZeRO-style
// sharded optimizer riding it): payload bytes / wall time of
// REDUCESCATTER responses, responses that took the exact-parity
// fallback (full allreduce + slice), and sharded-optimizer steps the
// Python frontends completed (noted like local_sgd_syncs).
int64_t horovod_reducescatter_bytes() {
  return Engine::Get().reducescatter_bytes();
}
int64_t horovod_reducescatter_ns() {
  return Engine::Get().reducescatter_ns();
}
int64_t horovod_reducescatter_fallbacks() {
  return Engine::Get().reducescatter_fallback_count();
}
int64_t horovod_sharded_steps() { return Engine::Get().sharded_steps(); }
void horovod_note_sharded_step() { Engine::Get().NoteShardedStep(); }
// Alltoall observability (first-class collective + the MoE plane riding
// it): payload bytes / wall time of ALLTOALL responses — Python's
// stats() derives alltoall_bus_bw_bytes_per_sec = (N-1)/N·bytes/wall —
// plus cumulative MoE drop-token accounting (noted per dispatch from
// runtime/moe.py so it rides the TELEM fleet aggregation).
int64_t horovod_alltoall_bytes() { return Engine::Get().alltoall_bytes(); }
int64_t horovod_alltoall_ns() { return Engine::Get().alltoall_ns(); }
int64_t horovod_moe_tokens_dropped() {
  return Engine::Get().moe_tokens_dropped();
}
void horovod_note_moe_dispatch(int64_t dropped) {
  Engine::Get().NoteMoeDispatch(dropped);
}
// Alltoall enqueue with the variable per-rank split surface: `splits`
// (nsplits = world size entries, summing to shape[0]) is this rank's
// per-destination dim-0 row counts; nsplits = 0 is the legacy
// equal-split contract.  wire_dtype/wire_advisory/priority behave
// exactly as in horovod_enqueue_priority.
int64_t horovod_enqueue_alltoall(const char* name, int dtype, int ndim,
                                 const int64_t* shape, void* data,
                                 const int64_t* splits, int nsplits,
                                 int wire_dtype, int wire_advisory,
                                 int priority) {
  std::vector<int64_t> dims(shape, shape + ndim);
  std::vector<int64_t> sp;
  if (splits != nullptr && nsplits > 0) sp.assign(splits, splits + nsplits);
  return Engine::Get().Enqueue(RequestType::ALLTOALL, name,
                               static_cast<DataType>(dtype), dims, data,
                               /*root_rank=*/-1, hvd::ReduceOp::SUM,
                               /*probe=*/false, wire_dtype, priority,
                               wire_advisory != 0, sp);
}
int64_t horovod_num_channels() {
  return static_cast<int64_t>(Engine::Get().num_channels());
}

// Shared-memory / hierarchy observability: payload bytes through shm
// rings (also counted in data_bytes_*; shm is a transport of the same
// data plane), bytes exchanged with co-located ranks, allreduce responses
// per algorithm path (latency star vs. bandwidth ring), and the committed
// host topology (host count x this rank's group size).
int64_t horovod_shm_bytes_tx() { return Engine::Get().shm_bytes_tx(); }
int64_t horovod_shm_bytes_rx() { return Engine::Get().shm_bytes_rx(); }
int64_t horovod_intra_host_bytes() {
  return Engine::Get().intra_host_bytes();
}
int64_t horovod_algo_small_count() {
  return Engine::Get().algo_small_count();
}
int64_t horovod_algo_ring_count() {
  return Engine::Get().algo_ring_count();
}
int64_t horovod_topology_hosts() {
  return static_cast<int64_t>(Engine::Get().topology_hosts());
}
int64_t horovod_topology_local_ranks() {
  return static_cast<int64_t>(Engine::Get().topology_local_ranks());
}
int64_t horovod_shm_enabled() {
  return Engine::Get().shm_enabled() ? 1 : 0;
}
int64_t horovod_algo_threshold() { return Engine::Get().algo_threshold(); }

// Wire-compression observability (see Engine accessors): buffer-level
// bytes saved by the wire representation, compressed ring payload sent,
// cumulative (de)quantization kernel time, and per-mode response counts.
int64_t horovod_wire_bytes_saved() {
  return Engine::Get().wire_bytes_saved();
}
int64_t horovod_compressed_bytes_tx() {
  return Engine::Get().compressed_bytes_tx();
}
int64_t horovod_quantize_ns() { return Engine::Get().quantize_ns(); }
int64_t horovod_wire_fp16_count() {
  return Engine::Get().wire_fp16_count();
}
int64_t horovod_wire_bf16_count() {
  return Engine::Get().wire_bf16_count();
}
int64_t horovod_wire_int8_count() {
  return Engine::Get().wire_int8_count();
}
int64_t horovod_wire_fp8_count() {
  return Engine::Get().wire_fp8_count();
}
// Effective default wire dtype (WireDtype value; live-tunable knob #6).
int64_t horovod_wire_dtype() {
  return static_cast<int64_t>(Engine::Get().wire_dtype());
}

// Priority scheduling (HOROVOD_PRIORITY_BANDS): the committed band
// width (0 = off — legacy arrival ordering bit-for-bit) and the
// deterministic inversions counter (committed responses dispatched
// after a less-urgent response of the same cycle; 0 by construction
// with bands on).
int64_t horovod_priority_bands() {
  return Engine::Get().priority_bands();
}
int64_t horovod_priority_inversions() {
  return Engine::Get().priority_inversions();
}

// Straggler-tolerance observability (HOROVOD_BACKUP_WORKERS / local
// SGD): the committed over-provisioning, how many partial commits left
// THIS rank out, outer local-SGD syncs noted by the Python policy, and
// sliding-window percentiles of allreduce completion latency
// (enqueue → finish) — the deterministic instrument the straggler gate
// compares between k=0 and k=1 runs.
int64_t horovod_backup_workers() {
  return static_cast<int64_t>(Engine::Get().backup_workers());
}
// HOROVOD_BACKUP_WORKERS=auto: whether auto mode is on, the arming
// ratio threshold (milli-units — the C ABI stays int64-only), and
// whether the coordinator's step-time window currently arms k=1
// (workers report 0; commits reach them inside responses).
int64_t horovod_backup_auto() {
  return Engine::Get().backup_auto() ? 1 : 0;
}
int64_t horovod_backup_auto_ratio_milli() {
  return Engine::Get().backup_auto_ratio_milli();
}
int64_t horovod_backup_armed() {
  return Engine::Get().backup_armed() ? 1 : 0;
}
int64_t horovod_backup_skips() { return Engine::Get().backup_skips(); }
// Link self-healing (HOROVOD_LINK_RETRIES / HOROVOD_LINK_HEAL_TIMEOUT_MS):
// data-channel edges transparently re-established mid-collective, suspects
// that exhausted the retry/deadline budget and escalated to the unchanged
// abort path, sliding-window percentiles of suspect→healed durations, and
// the committed knob values (the coordinator's resolution rides the
// rendezvous ASSIGN, like the channel count).  All counters are provably
// zero under HOROVOD_LINK_RETRIES=0.
int64_t horovod_link_reconnects() {
  return Engine::Get().link_reconnects();
}
int64_t horovod_link_heal_failures() {
  return Engine::Get().link_heal_failures();
}
int64_t horovod_link_heal_ns_p50() {
  return Engine::Get().link_heal_ns_p50();
}
int64_t horovod_link_heal_ns_p99() {
  return Engine::Get().link_heal_ns_p99();
}
int64_t horovod_link_retries() {
  return static_cast<int64_t>(Engine::Get().link_retries());
}
int64_t horovod_link_heal_timeout_ms() {
  return Engine::Get().link_heal_timeout_ms();
}
int64_t horovod_local_sgd_syncs() {
  return Engine::Get().local_sgd_syncs();
}
void horovod_note_local_sgd_sync() { Engine::Get().NoteLocalSgdSync(); }
int64_t horovod_step_time_ns_p50() {
  return Engine::Get().step_time_ns_p50();
}
int64_t horovod_step_time_ns_p99() {
  return Engine::Get().step_time_ns_p99();
}
// Ranks whose data a finished handle's response actually reduced (size
// for a full commit, the participant count for a backup-worker partial
// commit, 0 for a skipped entry): divisor-correct averaging divides by
// this, never blindly by size.
int64_t horovod_result_participants(int64_t handle) {
  return static_cast<int64_t>(Engine::Get().ResultParticipants(handle));
}

// Effective (currently in-force) knob values for stats()["config"]:
// post-autotune, not the env defaults — chunk/fusion/cycle/wave are
// live-tunable, the rest report the committed wiring-time resolution.
int64_t horovod_chunk_bytes() { return Engine::Get().chunk_bytes(); }
int64_t horovod_fusion_threshold() {
  return Engine::Get().fusion_threshold();
}
int64_t horovod_cycle_time_ms() {
  return static_cast<int64_t>(Engine::Get().cycle_time_ms());
}
int64_t horovod_wave_width() {
  return static_cast<int64_t>(Engine::Get().wave_width());
}
int64_t horovod_channel_drivers() {
  return static_cast<int64_t>(Engine::Get().channel_drivers());
}
int64_t horovod_cache_capacity() { return Engine::Get().cache_capacity(); }
int64_t horovod_socket_buf_bytes() {
  return static_cast<int64_t>(Engine::Get().socket_buf_bytes());
}

// TUNE frames applied on this rank; zero under HOROVOD_AUTOTUNE=0 (the
// observable proof that the default path never sees a TUNE frame).
int64_t horovod_tune_trials() { return Engine::Get().tune_trials(); }

// Online-autotuner proposal (coordinator only): queue a knob config for
// the next cycle's epoch-stamped TUNE broadcast; every rank applies it
// between cycles.  Values <= 0 leave that knob unchanged — EXCEPT
// algo_threshold, where 0 is a real value (small path off) and "leave
// unchanged" is < 0; commit != 0 marks the search's final config.
// Returns 0 queued, -1 when not initialized or not the coordinator.
// `priority_bands` < 0 leaves the band width unchanged (0 is real:
// bands off); `fusion_ladder` (ladder_n entries, may be null/0) sets
// band b's fusion threshold where the entry is > 0.  Callers gate on
// the horovod_priority_bands symbol before using this signature (the
// same stale-.so discipline as the wire_dtype extension before it).
int horovod_autotune_set(int64_t chunk_bytes, int64_t fusion_threshold,
                         int64_t cycle_time_ms, int64_t wave_width,
                         int64_t algo_threshold, int64_t wire_dtype,
                         int64_t priority_bands,
                         const int64_t* fusion_ladder, int ladder_n,
                         int commit) {
  std::vector<int64_t> ladder;
  if (fusion_ladder != nullptr && ladder_n > 0) {
    ladder.assign(fusion_ladder, fusion_ladder + ladder_n);
  }
  return Engine::Get().QueueTune(chunk_bytes, fusion_threshold,
                                 cycle_time_ms, wave_width, algo_threshold,
                                 wire_dtype, priority_bands, ladder,
                                 commit != 0);
}

// -- fleet observability plane (HOROVOD_TELEMETRY_CYCLES /
//    HOROVOD_FLIGHT_RECORDER_*) --

// Telemetry cadence in force (0 = off: frames byte-identical to the
// pre-telemetry wire), bytes the TELEM piggyback added to this rank's
// control frames, and stalled-tensor warnings emitted by this process
// (the horovod_stall_warnings_total metric's source).
int64_t horovod_telemetry_cycles() {
  return Engine::Get().telemetry_cycles();
}
int64_t horovod_telem_bytes_tx() { return Engine::Get().telem_bytes_tx(); }
int64_t horovod_stall_warnings() { return Engine::Get().stall_warnings(); }

// Rendezvous-estimated monotonic clock offset to rank 0 (rank0_now ≈
// my_now + offset; 0 on rank 0) — the merged timeline's alignment term.
int64_t horovod_clock_offset_ns() {
  return Engine::Get().clock_offset_ns();
}

// Coordinator quorum-lag percentiles: per committed negotiation, how
// long the LAST voter trailed the second-to-last.  The default
// HOROVOD_BACKUP_WORKERS=auto rule arms from these (rule: 0 = quorum,
// 1 = steptime via HOROVOD_BACKUP_AUTO_RULE).
int64_t horovod_quorum_lag_ns_p50() {
  return Engine::Get().quorum_lag_ns_p50();
}
int64_t horovod_quorum_lag_ns_p99() {
  return Engine::Get().quorum_lag_ns_p99();
}
int64_t horovod_backup_auto_rule() {
  return static_cast<int64_t>(Engine::Get().backup_auto_rule());
}

// Rank 0's fleet table as JSON (per-rank/per-host rows of telemetry
// counter sums, step-time gauges, slowest-rank attribution, quorum-lag
// percentiles).  Fills buf when it fits; ALWAYS returns the required
// byte length (excluding the NUL) so callers can retry with a bigger
// buffer.  Number of rows via horovod_fleet_rows.
int64_t horovod_fleet_json(char* buf, int64_t buflen) {
  std::string json = Engine::Get().FleetJson();
  if (buf != nullptr && buflen > 0) {
    size_t n = std::min(json.size(), static_cast<size_t>(buflen - 1));
    memcpy(buf, json.data(), n);
    buf[n] = '\0';
  }
  return static_cast<int64_t>(json.size());
}
int64_t horovod_fleet_rows() { return Engine::Get().fleet_rows(); }

// Flight recorder: events recorded / dumps written so far, and a manual
// dump trigger (tests, operator tooling).  Dumps land in
// HOROVOD_FLIGHT_RECORDER_DIR as flightrec.rank<r>.json.
int64_t horovod_flight_events() {
  return hvd::GlobalFlightRecorder().events_recorded();
}
int64_t horovod_flight_dumps() {
  return hvd::GlobalFlightRecorder().dumps_written();
}
int horovod_flight_dump(const char* reason) {
  return Engine::Get().FlightDump(reason ? reason : "manual dump");
}
// Python-plane events (checkpoint commits/restores, weight pushes)
// recorded into the same ring as aborts/link events, so postmortem
// merges them into one timeline.  Cycle 0: these events originate
// outside the coordinator's control cycle.
void horovod_flight_note(const char* kind, const char* text) {
  hvd::GlobalFlightRecorder().Record(kind ? kind : "note", 0, "%s",
                                     text ? text : "");
}

// Why the engine aborted, copied into buf (truncated to buflen-1); empty
// while the engine is healthy or after a clean shutdown.  Lets callers
// attach the culprit rank to enqueues attempted AFTER the abort, whose
// handles never existed.
void horovod_abort_reason(char* buf, int buflen) {
  std::string msg = Engine::Get().AbortReason();
  if (buflen <= 0) return;
  size_t n = std::min(msg.size(), static_cast<size_t>(buflen - 1));
  memcpy(buf, msg.data(), n);
  buf[n] = '\0';
}

int horovod_poll(int64_t handle) { return Engine::Get().Poll(handle); }
int horovod_wait(int64_t handle) { return Engine::Get().Wait(handle); }

// Copies the handle's error message into buf (truncated to buflen-1).
void horovod_error_message(int64_t handle, char* buf, int buflen) {
  std::string msg = Engine::Get().ErrorMessage(handle);
  if (buflen <= 0) return;
  size_t n = std::min(msg.size(), static_cast<size_t>(buflen - 1));
  memcpy(buf, msg.data(), n);
  buf[n] = '\0';
}

int64_t horovod_result_ndim(int64_t handle) {
  return Engine::Get().ResultNumDims(handle);
}
int64_t horovod_result_dim(int64_t handle, int i) {
  return Engine::Get().ResultDim(handle, i);
}
int64_t horovod_result_bytes(int64_t handle) {
  return Engine::Get().ResultByteSize(handle);
}
int horovod_copy_result(int64_t handle, void* dst, int64_t nbytes) {
  return Engine::Get().CopyResult(handle, dst, nbytes);
}
void horovod_release_handle(int64_t handle) {
  Engine::Get().ReleaseHandle(handle);
}

}  // extern "C"
