// Control-plane wire protocol.
//
// Role parity with the reference's FlatBuffers messages
// (horovod/common/mpi_message.{h,cc} + wire/mpi_message.fbs): Request /
// RequestList flow worker→coordinator, Response / ResponseList flow back.
// The encoding here is a deliberately simple length-prefixed binary format
// (no schema compiler, no vendored library): all peers run the same build
// on the same arch, so cross-version schema evolution — FlatBuffers' reason
// to exist — buys nothing for an in-cluster control plane.
#pragma once

#include <cstdint>
#include <string>
#include <vector>

#include "common.h"

namespace hvd {

enum class RequestType : uint8_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  // Extensions beyond the reference wire protocol (the reference's eager
  // surface stops at the three ops above); negotiated identically.
  REDUCESCATTER = 3,
  ALLTOALL = 4,
};

enum class ResponseType : uint8_t {
  ALLREDUCE = 0,
  ALLGATHER = 1,
  BROADCAST = 2,
  ERROR = 3,
  REDUCESCATTER = 4,
  ALLTOALL = 5,
  // Sparse-layout rendezvous (no reference equivalent; the reference
  // deadlocks when a torch param produces sparse grads on some ranks and
  // none on others in the same step): tells ranks whose dense LAYOUT-PROBE
  // allreduce conflicts with peers' pending sparse gathers to retry as a
  // zero-entry sparse gather.  tensor_sizes[0] carries the sparse_dim
  // gleaned from the peers' '<name>.idx' request shape.
  SPARSE_RETRY = 6,
};

inline const char* RequestTypeName(RequestType t) {
  switch (t) {
    case RequestType::ALLREDUCE: return "allreduce";
    case RequestType::ALLGATHER: return "allgather";
    case RequestType::BROADCAST: return "broadcast";
    case RequestType::REDUCESCATTER: return "reducescatter";
    case RequestType::ALLTOALL: return "alltoall";
  }
  return "?";
}

// Reduction operator for allreduce/reducescatter.  The reference wire
// protocol is SUM-only (mpi_message.h); MIN/MAX/PROD close the asymmetry
// with the jit path's psum/pmin/pmax/product collectives.
enum class ReduceOp : uint8_t {
  SUM = 0,
  MIN = 1,
  MAX = 2,
  PROD = 3,
};

inline const char* ReduceOpName(ReduceOp op) {
  switch (op) {
    case ReduceOp::SUM: return "sum";
    case ReduceOp::MIN: return "min";
    case ReduceOp::MAX: return "max";
    case ReduceOp::PROD: return "prod";
  }
  return "?";
}

struct Request {
  int32_t request_rank = 0;
  RequestType type = RequestType::ALLREDUCE;
  DataType dtype = DataType::FLOAT32;
  std::string tensor_name;
  int32_t root_rank = -1;   // broadcast only
  ReduceOp red_op = ReduceOp::SUM;  // allreduce/reducescatter only
  // Layout probe: "this rank has no local gradient for this tensor and
  // does not know its layout; these are placeholder zeros."  A probe
  // behaves as a normal dense allreduce participant unless the coordinator
  // sees peers gathering the tensor sparsely, in which case the probing
  // ranks get a SPARSE_RETRY response instead of a deadlock.
  bool probe = false;
  // Requested WIRE format for this tensor's allreduce payload (see
  // common.h WireDtype).  EXPLICIT per-tensor overrides are validated
  // cross-rank exactly like dtype: the coordinator commits ONE wire
  // format per response and a mismatch between overrides is a clean
  // negotiated error naming the ranks.  Always FP32 for non-fp32
  // tensors and non-allreduce ops.
  WireDtype wire_dtype = WireDtype::FP32;
  // Set when wire_dtype was resolved from the GLOBAL knob
  // (HOROVOD_WIRE_DTYPE / a live TUNE) rather than a per-tensor
  // override.  Knob-derived wires are ADVISORY: enqueue-time sampling
  // races TUNE application across ranks (one rank's enqueue lands a
  // cycle before a peer applied the same TUNE), so the coordinator
  // COMMITS the first non-probe request's value instead of erroring —
  // every rank executes the response's committed wire anyway, and the
  // next step's signatures converge.  Only explicit overrides keep the
  // strict mismatch error.
  bool wire_default = false;
  // Scheduling PRIORITY for this tensor (0 = most urgent, the default).
  // Frontends stamp it from registration order (first-registered ≈ front
  // layer ≈ needed first by the NEXT step's forward), so with
  // HOROVOD_PRIORITY_BANDS > 0 the coordinator can order each cycle's
  // responses by (priority, name) instead of arrival order.  Validated
  // cross-rank like dtype/wire (probes exempt).  On the wire it travels
  // in a trailing tagged section of the RequestList carrying only the
  // NONZERO entries — an all-default frame is byte-identical to the
  // pre-priority protocol.
  int32_t priority = 0;
  std::vector<int64_t> shape;
  // Alltoall only: this rank's per-destination dim-0 row counts (size_
  // entries summing to shape[0]).  EMPTY means the legacy equal-split
  // contract (shape[0] divisible by world size).  Validated cross-rank
  // like the dim-0 allgather's geometry; the committed size×size split
  // matrix rides Response::tensor_sizes row-major.
  std::vector<int64_t> splits;
};

// Fleet telemetry (HOROVOD_TELEMETRY_CYCLES): every N negotiation cycles
// a rank piggybacks one TelemEntry of COUNTER DELTAS (since its previous
// send) on its RequestList, so rank 0 can maintain a fleet-wide counter
// table without a second wire protocol.  The deltas vector follows the
// fixed kTelemCounter order (engine.h); deltas-not-absolutes make the
// aggregation exact under hierarchical coordination, where a host
// leader SUMS its members' entries into one per-host entry (nranks
// grows, rank becomes the leader's) so rank 0 still receives O(hosts)
// telemetry bytes per telemetry cycle.  step/quorum percentiles are
// GAUGES (max-merged), with `slow_rank` attributing the worst step-time
// p99 inside a merged entry.
struct TelemEntry {
  int32_t rank = 0;        // reporting rank (host leader after a merge)
  int32_t nranks = 1;      // ranks aggregated into this entry
  int32_t host = 0;        // committed host-group id
  int64_t step_p50 = 0;    // step_time_ns_p50 gauge
  int64_t step_p99 = 0;    // step_time_ns_p99 gauge
  int32_t slow_rank = -1;  // rank with the largest step_p99 in this entry
  int64_t slow_p99 = 0;
  std::vector<int64_t> deltas;  // kTelemCounter order
};

struct RequestList {
  // Membership epoch this frame belongs to (elastic in-place resize).
  // Every control message is stamped with the sender's committed epoch;
  // a receiver on epoch E structurally rejects frames stamped != E, so a
  // delayed message from a dead incarnation of the world can never poison
  // the resized world's negotiation state (or replay a stale cache slot —
  // the PR 2 response cache is thereby keyed per-epoch).
  int64_t epoch = 0;
  std::vector<Request> requests;
  bool shutdown = false;    // shutdown piggybacks on the control stream
  // Hierarchical coordination: a sub-coordinator (per-host group leader)
  // that loses one of its local members cannot broadcast an abort itself
  // — it reports the culprit here so rank 0's abort verdict names the
  // rank that actually died, not the leader that noticed.  -1 = healthy.
  int32_t fail_rank = -1;
  std::string fail_message;
  // Response-cache control (upstream Horovod 0.21's bitvector idea): a
  // tensor whose (name, type, dtype, shape, root, op) was negotiated
  // before is reported as a single bit — the coordinator-assigned cache
  // slot id — instead of a full serialized Request.  On the wire the
  // hits travel bit-packed (slot ids are dense, bounded by
  // HOROVOD_CACHE_CAPACITY), so a steady-state step is a few bytes.
  std::vector<uint32_t> cache_hits;    // slot ids this rank is ready on
  // Slots this rank invalidated (same name re-enqueued with a different
  // signature); the full replacement Request rides in `requests` in the
  // same frame.
  std::vector<uint32_t> cache_evicts;
  // Piggybacked fleet telemetry (see TelemEntry).  The wire section is
  // appended ONLY when non-empty, and the parser reads it only when
  // bytes remain after the PR 12 fields — so HOROVOD_TELEMETRY_CYCLES=0
  // frames are BYTE-IDENTICAL to the pre-telemetry protocol, and an
  // idle telemetry cycle costs nothing at all (no flag byte: absence is
  // the flag).  Trailing sections are TAGGED (one u8 each: 1 = telem,
  // 2 = request priorities) so independent optional piggybacks compose
  // without spending bytes on the common all-absent frame.
  std::vector<TelemEntry> telem;
};

struct Response {
  ResponseType type = ResponseType::ALLREDUCE;
  // >1 names ⇒ fused batch executed as one collective.
  std::vector<std::string> tensor_names;
  std::string error_message;
  // Allgather: per-rank dim-0 sizes (negotiated dynamic shape).
  std::vector<int64_t> tensor_sizes;
  int32_t root_rank = -1;
  ReduceOp red_op = ReduceOp::SUM;
  // Committed wire format for this (possibly fused) allreduce response:
  // every rank validated-ly requested it, so the data plane quantizes/
  // dequantizes identically on all of them.  FP32 everywhere else.
  WireDtype wire_dtype = WireDtype::FP32;
  // Parallel to tensor_names: the cache slot the coordinator assigned to
  // each tensor (-1 = uncached).  Every rank inserts (name → slot,
  // slot → single-tensor response) into its local cache replica on
  // receipt, so later steps negotiate via RequestList::cache_hits.
  std::vector<int32_t> cache_slots;
  // Backup-worker PARTIAL commit (HOROVOD_BACKUP_WORKERS=k): the
  // committed participant rank set when the coordinator fired this SUM
  // allreduce at size-k voter readiness instead of waiting for the full
  // world.  Empty = full commit, the default contract (k=0 frames carry
  // one flag byte and nothing else).  Every rank executes the SAME ring
  // over the SAME response — a rank outside the set contributes a
  // zeroed buffer (zero is the SUM identity) so the wire pattern always
  // spans the whole world; partial_elems/partial_dtype carry the
  // payload geometry a skipped rank (which may hold no tensor entry at
  // all) needs to size that buffer.  Partial responses are never fused
  // and never assigned cache slots.
  std::vector<uint32_t> participants;
  int64_t partial_elems = 0;
  uint8_t partial_dtype = 0;
  // Committed scheduling priority of this (possibly fused) response.
  // NONZERO values ride the ResponseList's trailing tagged section
  // (tag 3) so every rank — including one that joined the negotiation
  // via a layout probe, whose own stamp was 0 — dispatches in the same
  // committed order; absence on the wire means "committed 0", keeping
  // the default frame byte-identical to the legacy protocol.  -1 = not
  // resolved yet (non-executable responses stay -1).
  int32_t priority = -1;
};

struct ResponseList {
  // Membership epoch (see RequestList::epoch).  Workers drop response
  // frames — including abort verdicts — stamped with a different epoch.
  int64_t epoch = 0;
  std::vector<Response> responses;
  bool shutdown = false;
  // Fault-tolerance abort broadcast: when the coordinator loses a rank
  // (EOF, keepalive, or HOROVOD_FAULT_TIMEOUT_SEC exceeded) it ships this
  // instead of a normal cycle so every SURVIVING rank fails its in-flight
  // and queued collectives promptly with a message naming the culprit,
  // rather than each rank discovering the death via its own transport
  // timeout one collective at a time.
  bool abort = false;
  int32_t abort_rank = -1;      // the rank the coordinator lost
  std::string abort_message;
  // Slots every rank agreed on this cycle (all size_ hit bits seen):
  // each rank executes the response stored in its local cache replica —
  // the coordinator never re-runs ConstructResponse and ships only the
  // slot ids.  Ascending slot order = deterministic execution order.
  std::vector<uint32_t> cached_slots;
  // Slots invalidated this cycle; every rank drops them from its replica.
  // A rank with a pending hit bit on an evicted slot resubmits that
  // tensor as a full Request next cycle.  Applied BEFORE cache_slots
  // assignments from the same frame (a freed slot may be reassigned in
  // the very cycle it was evicted).
  std::vector<uint32_t> evict_slots;
  // Online-autotuner TUNE broadcast (piggybacks on the regular cycle
  // frame, like `abort`): when `tune` is set, every receiver applies the
  // carried knob values BEFORE executing this cycle's responses — i.e.
  // atomically between negotiation cycles (no response in flight; and a
  // completion-woken enqueue can never read a stale knob a peer already
  // flipped), so no collective ever runs under a mixed config across
  // ranks.  The frame inherits the epoch
  // stamp above, so a TUNE from a dead incarnation of the world is
  // structurally dropped (and counted in stale_epoch_msgs) like any
  // other stale control frame.  A value <= 0 means "leave that knob
  // unchanged"; `tune_commit` marks the search's final (committed)
  // config for the timeline and observability.
  bool tune = false;
  bool tune_commit = false;
  int64_t tune_trial_id = 0;
  int64_t tune_chunk_bytes = 0;
  int64_t tune_fusion_threshold = 0;
  int32_t tune_cycle_time_ms = 0;
  int32_t tune_wave_width = 0;
  // Size-based algorithm-selection crossover (HOROVOD_ALGO_THRESHOLD).
  // Unlike the knobs above, 0 is a REAL value (small path disabled), so
  // "leave unchanged" is < 0.
  int64_t tune_algo_threshold = -1;
  // Live-tunable default wire dtype (the 6th knob): 0 (fp32) is a real
  // value, so "leave unchanged" is < 0.  Applies to enqueues AFTER the
  // frame lands; in-flight negotiations keep their requested format, and
  // the signature change evicts affected cache slots naturally.
  int32_t tune_wire_dtype = -1;
  // Priority band width (HOROVOD_PRIORITY_BANDS, the 7th live-tunable
  // knob): 0 is a REAL value (bands off = legacy arrival ordering), so
  // "leave unchanged" is < 0.
  int64_t tune_priority_bands = -1;
  // Per-band fusion-threshold ladder (autotuner-learned bucket sizes):
  // entry b sets band b's fusion threshold; <= 0 leaves that band
  // unchanged; an EMPTY vector leaves the whole ladder unchanged.
  std::vector<int64_t> tune_fusion_ladder;
  // Cached slots of this cycle's `cached_slots` that fired as
  // backup-worker PARTIAL commits: slot → committed participant set
  // (the replayed replica response provides the payload geometry from
  // its signature).  Leaders also drop their held sub-table bits for
  // these slots — the skipped group's ready members just had their
  // entries finished "skipped" and will re-report fresh.
  struct PartialSlot {
    uint32_t slot = 0;
    std::vector<uint32_t> participants;
  };
  std::vector<PartialSlot> partial_slots;
};

// Flat byte-buffer serialization (host byte order; in-cluster only).
// Fixed-width u32/i32/i64 remain for rendezvous handshakes (magic tags,
// pre-negotiation fields); the per-cycle control frames use the varint
// encoders below so steady-state negotiation bytes scale with the VALUES
// on the wire (small slot ids, small counts, small dims), not with the
// widest field any frame might ever need.
class Writer {
 public:
  void u8(uint8_t v) { buf_.push_back(v); }
  void u32(uint32_t v) { append(&v, 4); }
  void i32(int32_t v) { append(&v, 4); }
  void i64(int64_t v) { append(&v, 8); }
  // LEB128 varint: 7 value bits per byte, high bit = continuation.
  void vu(uint64_t v) {
    while (v >= 0x80) {
      buf_.push_back(static_cast<uint8_t>(v) | 0x80);
      v >>= 7;
    }
    buf_.push_back(static_cast<uint8_t>(v));
  }
  // ZigZag-mapped signed varint: small magnitudes of either sign stay
  // one byte (epochs, root ranks incl. -1, tensor dims).
  void vi(int64_t v) {
    vu((static_cast<uint64_t>(v) << 1) ^
       static_cast<uint64_t>(v >> 63));
  }
  void str(const std::string& s) {
    vu(s.size());
    append(s.data(), s.size());
  }
  const std::vector<uint8_t>& bytes() const { return buf_; }

 private:
  void append(const void* p, size_t n) {
    const uint8_t* b = static_cast<const uint8_t*>(p);
    buf_.insert(buf_.end(), b, b + n);
  }
  std::vector<uint8_t> buf_;
};

class Reader {
 public:
  Reader(const uint8_t* data, size_t size) : p_(data), end_(data + size) {}
  uint8_t u8() { return *take(1); }
  uint32_t u32() { uint32_t v; memcpy(&v, take(4), 4); return v; }
  int32_t i32() { int32_t v; memcpy(&v, take(4), 4); return v; }
  int64_t i64() { int64_t v; memcpy(&v, take(8), 8); return v; }
  uint64_t vu() {
    uint64_t v = 0;
    for (int shift = 0; shift < 64; shift += 7) {
      uint8_t b = u8();
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if ((b & 0x80) == 0) return v;
    }
    ok_ = false;  // > 10 continuation bytes: corrupt frame
    return 0;
  }
  int64_t vi() {
    uint64_t v = vu();
    return static_cast<int64_t>((v >> 1) ^ (~(v & 1) + 1));
  }
  std::string str() {
    uint64_t n = vu();
    // Compare against the REMAINING length, never via p_ + n: with an
    // untrusted varint n near 2^64 the pointer sum overflows (UB) and
    // the check silently passes — a corrupt frame must fail parse
    // cleanly, not wrap into a multi-exabyte string construction.
    if (n > static_cast<uint64_t>(end_ - p_)) {
      ok_ = false;
      return std::string();
    }
    const uint8_t* s = take(static_cast<size_t>(n));
    return std::string(reinterpret_cast<const char*>(s), n);
  }
  bool ok() const { return ok_; }
  // Bytes not yet consumed.  Trailing optional sections (the TELEM
  // piggyback) are gated on this instead of a flag byte, so a frame
  // without the section is byte-identical to the pre-section protocol.
  size_t remaining() const { return static_cast<size_t>(end_ - p_); }

 private:
  const uint8_t* take(size_t n) {
    if (n > static_cast<size_t>(end_ - p_)) {
      ok_ = false;
      static uint8_t zero[8] = {0};
      return zero;
    }
    const uint8_t* r = p_;
    p_ += n;
    return r;
  }
  const uint8_t* p_;
  const uint8_t* end_;
  bool ok_ = true;
};

// -- link self-healing handshake (data-plane reconnect) --
//
// When a data-channel socket fails mid-collective and HOROVOD_LINK_RETRIES
// allows healing, the edge's ORIGIN (the ring sender, who opened the
// original wiring connect) re-dials the receiver's data listener and sends
// a RESUME hello instead of the 4-int wiring handshake; the receiver
// answers with an ACK carrying its authoritative chunk-cascade cursor
// (stream seq, step, byte offset within the step) so the sender rewinds
// and the collective completes bit-identically.  Fixed-width frames on a
// raw socket (both ends are the same build on the same arch): 6 and 5
// int64s, distinguished from wiring hellos by the magic in word 0 —
// wiring hellos start with a rank in [0, 2^31), these start with a magic
// far outside any epoch-stamped rank/field value.
constexpr int64_t kLinkResumeMagic = 0x4c52534d31ll;  // "LRSM1"
constexpr int64_t kLinkAckMagic = 0x4c52414b31ll;     // "LRAK1"

struct LinkResume {
  int64_t magic = kLinkResumeMagic;
  int64_t origin = -1;   // reconnecting rank (the edge's ring sender)
  int64_t ring = -1;     // RingId (engine.h): GLOBAL or CROSS
  int64_t channel = -1;  // global channel id of the failed edge
  int64_t epoch = -1;    // stale-incarnation connects are dropped, as ever
  int64_t seq = -1;      // sender's per-(ring,channel) cascade stream seq
};

struct LinkResumeAck {
  int64_t magic = kLinkAckMagic;
  int64_t ok = 0;      // 1 = cursor follows; 0 = declined (stream moved on)
  int64_t seq = -1;    // receiver's current stream seq for the channel
  int64_t step = 0;    // receiver's authoritative cascade step cursor
  int64_t offset = 0;  // bytes of `step` already received
};

// Validation-only decode helpers (the structs are sent raw): false when
// the magic does not match — the caller treats the frame as garbage.
bool ValidLinkResume(const LinkResume& r);
bool ValidLinkResumeAck(const LinkResumeAck& a);

void SerializeRequestList(const RequestList& list, Writer* w);
bool ParseRequestList(Reader* r, RequestList* out);
// Exposed for the engine's telem_bytes_tx accounting (the per-entry wire
// cost without serializing the whole frame twice).
void SerializeTelemEntry(const TelemEntry& t, Writer* w);
void SerializeResponseList(const ResponseList& list, Writer* w);
bool ParseResponseList(Reader* r, ResponseList* out);

}  // namespace hvd
