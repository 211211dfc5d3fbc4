#include "message.h"

#include <algorithm>

namespace hvd {

// Per-cycle control frames are varint-coded end to end (see Writer::vu):
// a steady-state negotiation frame is a handful of one-byte fields, and
// the worst offenders of the fixed-width format — 8-byte epochs, 4-byte
// counts, 8-byte shape dims — shrink to their value's natural size.

static void SerializeRequest(const Request& q, Writer* w) {
  w->vu(static_cast<uint64_t>(q.request_rank));
  w->u8(static_cast<uint8_t>(q.type));
  w->u8(static_cast<uint8_t>(q.dtype));
  w->str(q.tensor_name);
  w->vi(q.root_rank);
  w->u8(static_cast<uint8_t>(q.red_op));
  w->u8(q.probe ? 1 : 0);
  w->u8(static_cast<uint8_t>(q.wire_dtype));
  w->u8(q.wire_default ? 1 : 0);
  w->vu(q.shape.size());
  for (auto d : q.shape) w->vi(d);
  w->vu(q.splits.size());
  for (auto s : q.splits) w->vi(s);
}

static bool ParseRequest(Reader* r, Request* q) {
  q->request_rank = static_cast<int32_t>(r->vu());
  q->type = static_cast<RequestType>(r->u8());
  q->dtype = static_cast<DataType>(r->u8());
  q->tensor_name = r->str();
  q->root_rank = static_cast<int32_t>(r->vi());
  q->red_op = static_cast<ReduceOp>(r->u8());
  q->probe = r->u8() != 0;
  q->wire_dtype = static_cast<WireDtype>(r->u8());
  q->wire_default = r->u8() != 0;
  uint64_t nd = r->vu();
  if (nd > (1u << 16)) return false;  // corrupt frame guard
  q->shape.clear();
  for (uint64_t i = 0; i < nd && r->ok(); ++i) q->shape.push_back(r->vi());
  uint64_t ns = r->vu();
  if (ns > (1u << 16)) return false;  // corrupt frame guard
  q->splits.clear();
  for (uint64_t i = 0; i < ns && r->ok(); ++i) q->splits.push_back(r->vi());
  return r->ok();
}

// Cache-hit slot ids travel bit-packed: varint bit count (highest set slot
// + 1, 0 when no hits) followed by ceil(nbits/8) bytes.  Slot ids are
// dense and bounded by HOROVOD_CACHE_CAPACITY, so a steady-state cycle's
// whole readiness report is a handful of bytes.
static void SerializeSlotBitvector(const std::vector<uint32_t>& slots,
                                   Writer* w) {
  uint32_t nbits = 0;
  for (auto s : slots) nbits = std::max(nbits, s + 1);
  w->vu(nbits);
  std::vector<uint8_t> bits((nbits + 7) / 8, 0);
  for (auto s : slots) bits[s / 8] |= static_cast<uint8_t>(1u << (s % 8));
  for (auto b : bits) w->u8(b);
}

static bool ParseSlotBitvector(Reader* r, std::vector<uint32_t>* slots) {
  slots->clear();
  uint64_t nbits = r->vu();
  if (!r->ok() || nbits > (1u << 20)) return false;  // corrupt frame guard
  for (uint64_t byte = 0; byte < (nbits + 7) / 8; ++byte) {
    uint8_t b = r->u8();
    for (uint64_t i = 0; i < 8 && byte * 8 + i < nbits; ++i) {
      if (b & (1u << i)) {
        slots->push_back(static_cast<uint32_t>(byte * 8 + i));
      }
    }
  }
  return r->ok();
}

// Explicit slot lists (cached/evicted ids) go ascending delta-varint:
// sorted once, each id is encoded as its distance from the previous one —
// dense id ranges (the common case: smallest-first reuse keeps them low)
// collapse to one byte per slot.  Order was never semantic: the receiver
// applies evictions idempotently and executes cached slots in ascending
// id order anyway (the sort here IS that order).
static void SerializeSlotList(std::vector<uint32_t> slots, Writer* w) {
  std::sort(slots.begin(), slots.end());
  w->vu(slots.size());
  uint32_t prev = 0;
  for (auto s : slots) {
    w->vu(s - prev);
    prev = s;
  }
}

static bool ParseSlotList(Reader* r, std::vector<uint32_t>* slots) {
  slots->clear();
  uint64_t n = r->vu();
  if (n > (1u << 20)) return false;  // corrupt frame guard
  uint32_t prev = 0;
  for (uint64_t i = 0; i < n && r->ok(); ++i) {
    prev += static_cast<uint32_t>(r->vu());
    slots->push_back(prev);
  }
  return r->ok();
}

// Telemetry piggyback: counter deltas are varint-coded (small deltas —
// the steady-state common case — are one byte each), gauges zigzag.
void SerializeTelemEntry(const TelemEntry& t, Writer* w) {
  w->vi(t.rank);
  w->vu(static_cast<uint64_t>(t.nranks));
  w->vu(static_cast<uint64_t>(t.host));
  w->vi(t.step_p50);
  w->vi(t.step_p99);
  w->vi(t.slow_rank);
  w->vi(t.slow_p99);
  w->vu(t.deltas.size());
  for (auto d : t.deltas) w->vi(d);
}

static bool ParseTelemEntry(Reader* r, TelemEntry* t) {
  t->rank = static_cast<int32_t>(r->vi());
  t->nranks = static_cast<int32_t>(r->vu());
  t->host = static_cast<int32_t>(r->vu());
  t->step_p50 = r->vi();
  t->step_p99 = r->vi();
  t->slow_rank = static_cast<int32_t>(r->vi());
  t->slow_p99 = r->vi();
  uint64_t n = r->vu();
  if (n > (1u << 10)) return false;  // corrupt frame guard
  t->deltas.clear();
  for (uint64_t i = 0; i < n && r->ok(); ++i) t->deltas.push_back(r->vi());
  return r->ok();
}

void SerializeRequestList(const RequestList& list, Writer* w) {
  w->vi(list.epoch);
  w->u8(list.shutdown ? 1 : 0);
  w->vu(list.requests.size());
  for (const auto& q : list.requests) SerializeRequest(q, w);
  SerializeSlotBitvector(list.cache_hits, w);
  SerializeSlotList(list.cache_evicts, w);
  // Sub-coordinator member-failure report behind a flag byte: the
  // healthy frame grows by exactly one byte.
  w->u8(list.fail_rank >= 0 ? 1 : 0);
  if (list.fail_rank >= 0) {
    w->vi(list.fail_rank);
    w->str(list.fail_message);
  }
  // Trailing TAGGED sections, each appended ONLY when present, so a
  // frame without any is byte-identical to the pre-section protocol
  // (the parser gates on remaining bytes, then dispatches on the tag).
  //
  // Tag 2: per-request scheduling priorities — only the NONZERO entries
  // travel, as (request index, priority) varint pairs parallel to the
  // `requests` vector, so an all-default frame (every frontend that
  // never stamps priorities) costs nothing.
  {
    uint64_t nonzero = 0;
    for (const auto& q : list.requests) {
      if (q.priority != 0) ++nonzero;
    }
    if (nonzero > 0) {
      w->u8(2);
      w->vu(nonzero);
      for (size_t i = 0; i < list.requests.size(); ++i) {
        if (list.requests[i].priority == 0) continue;
        w->vu(i);
        w->vu(static_cast<uint64_t>(list.requests[i].priority));
      }
    }
  }
  // Tag 1: fleet-telemetry piggyback (HOROVOD_TELEMETRY_CYCLES).
  if (!list.telem.empty()) {
    w->u8(1);
    w->vu(list.telem.size());
    for (const auto& t : list.telem) SerializeTelemEntry(t, w);
  }
}

bool ParseRequestList(Reader* r, RequestList* out) {
  out->epoch = r->vi();
  out->shutdown = r->u8() != 0;
  uint64_t n = r->vu();
  if (n > (1u << 20)) return false;
  out->requests.resize(n);
  for (uint64_t i = 0; i < n; ++i) {
    if (!ParseRequest(r, &out->requests[i])) return false;
  }
  if (!ParseSlotBitvector(r, &out->cache_hits)) return false;
  if (!ParseSlotList(r, &out->cache_evicts)) return false;
  if (r->u8() != 0) {
    out->fail_rank = static_cast<int32_t>(r->vi());
    out->fail_message = r->str();
  } else {
    out->fail_rank = -1;
    out->fail_message.clear();
  }
  out->telem.clear();
  // Trailing tagged sections (absence is the flag; see the serializer).
  while (r->ok() && r->remaining() > 0) {
    uint8_t tag = r->u8();
    if (tag == 1) {
      uint64_t n = r->vu();
      if (n > (1u << 16)) return false;
      out->telem.resize(n);
      for (uint64_t i = 0; i < n; ++i) {
        if (!ParseTelemEntry(r, &out->telem[i])) return false;
      }
    } else if (tag == 2) {
      uint64_t n = r->vu();
      if (n > (1u << 20)) return false;
      for (uint64_t i = 0; i < n && r->ok(); ++i) {
        uint64_t idx = r->vu();
        uint64_t prio = r->vu();
        if (idx >= out->requests.size() || prio > (1u << 30)) return false;
        out->requests[idx].priority = static_cast<int32_t>(prio);
      }
    } else {
      return false;  // unknown trailing section
    }
  }
  return r->ok();
}

static void SerializeResponse(const Response& s, Writer* w) {
  w->u8(static_cast<uint8_t>(s.type));
  w->vu(s.tensor_names.size());
  for (const auto& n : s.tensor_names) w->str(n);
  w->str(s.error_message);
  w->vu(s.tensor_sizes.size());
  for (auto v : s.tensor_sizes) w->vi(v);
  w->vi(s.root_rank);
  w->u8(static_cast<uint8_t>(s.red_op));
  w->u8(static_cast<uint8_t>(s.wire_dtype));
  w->vu(s.cache_slots.size());
  for (auto c : s.cache_slots) w->vi(c);
  // Backup-worker participant set behind a flag byte: the k=0 (and every
  // full-commit) frame grows by exactly one byte.
  w->u8(s.participants.empty() ? 0 : 1);
  if (!s.participants.empty()) {
    SerializeSlotBitvector(s.participants, w);
    w->vi(s.partial_elems);
    w->u8(s.partial_dtype);
  }
}

static bool ParseResponse(Reader* r, Response* s) {
  s->type = static_cast<ResponseType>(r->u8());
  uint64_t n = r->vu();
  if (n > (1u << 20)) return false;
  s->tensor_names.resize(n);
  for (uint64_t i = 0; i < n; ++i) s->tensor_names[i] = r->str();
  s->error_message = r->str();
  uint64_t m = r->vu();
  if (m > (1u << 20)) return false;
  s->tensor_sizes.clear();
  for (uint64_t i = 0; i < m && r->ok(); ++i) {
    s->tensor_sizes.push_back(r->vi());
  }
  s->root_rank = static_cast<int32_t>(r->vi());
  s->red_op = static_cast<ReduceOp>(r->u8());
  s->wire_dtype = static_cast<WireDtype>(r->u8());
  uint64_t c = r->vu();
  if (c > (1u << 20)) return false;
  s->cache_slots.clear();
  for (uint64_t i = 0; i < c && r->ok(); ++i) {
    s->cache_slots.push_back(static_cast<int32_t>(r->vi()));
  }
  // Normalize: every tensor name has a slot entry (-1 = uncached), so
  // consumers can index the two vectors in lockstep unconditionally.
  s->cache_slots.resize(s->tensor_names.size(), -1);
  if (r->u8() != 0) {
    if (!ParseSlotBitvector(r, &s->participants)) return false;
    s->partial_elems = r->vi();
    s->partial_dtype = r->u8();
  } else {
    s->participants.clear();
    s->partial_elems = 0;
    s->partial_dtype = 0;
  }
  return r->ok();
}

void SerializeResponseList(const ResponseList& list, Writer* w) {
  w->vi(list.epoch);
  w->u8(list.shutdown ? 1 : 0);
  w->u8(list.abort ? 1 : 0);
  w->vi(list.abort_rank);
  w->str(list.abort_message);
  w->vu(list.responses.size());
  for (const auto& s : list.responses) SerializeResponse(s, w);
  SerializeSlotList(list.cached_slots, w);
  SerializeSlotList(list.evict_slots, w);
  // TUNE payload behind a flag byte: the steady-state (and autotune-off)
  // frame grows by exactly one byte.
  w->u8(list.tune ? 1 : 0);
  if (list.tune) {
    w->u8(list.tune_commit ? 1 : 0);
    w->vi(list.tune_trial_id);
    w->vi(list.tune_chunk_bytes);
    w->vi(list.tune_fusion_threshold);
    w->vi(list.tune_cycle_time_ms);
    w->vi(list.tune_wave_width);
    w->vi(list.tune_algo_threshold);
    w->vi(list.tune_wire_dtype);
    w->vi(list.tune_priority_bands);
    w->vu(list.tune_fusion_ladder.size());
    for (auto v : list.tune_fusion_ladder) w->vi(v);
  }
  // Backup-worker partial commits on the cached path: slot → committed
  // participant bitmap.  Empty on every full-commit cycle (one byte).
  w->vu(list.partial_slots.size());
  for (const auto& ps : list.partial_slots) {
    w->vu(ps.slot);
    SerializeSlotBitvector(ps.participants, w);
  }
  // Trailing TAGGED section (absence is the flag, like the RequestList's
  // piggybacks): tag 3 = committed response priorities — only the
  // NONZERO entries travel, as (response index, priority) pairs.  A
  // rank that joined a negotiation via a layout PROBE stamped priority
  // 0 locally while its peers stamped the committed value; shipping the
  // committed priorities keeps the (priority, name) dispatch order —
  // and with it the wave/channel pairing — identical on every rank.
  // All-zero (the default) and legacy frames stay byte-identical.
  {
    uint64_t nonzero = 0;
    for (const auto& s : list.responses) {
      if (s.priority > 0) ++nonzero;
    }
    if (nonzero > 0) {
      w->u8(3);
      w->vu(nonzero);
      for (size_t i = 0; i < list.responses.size(); ++i) {
        if (list.responses[i].priority <= 0) continue;
        w->vu(i);
        w->vu(static_cast<uint64_t>(list.responses[i].priority));
      }
    }
  }
}

bool ParseResponseList(Reader* r, ResponseList* out) {
  out->epoch = r->vi();
  out->shutdown = r->u8() != 0;
  out->abort = r->u8() != 0;
  out->abort_rank = static_cast<int32_t>(r->vi());
  out->abort_message = r->str();
  uint64_t n = r->vu();
  if (n > (1u << 20)) return false;
  out->responses.resize(n);
  for (uint64_t i = 0; i < n; ++i) {
    if (!ParseResponse(r, &out->responses[i])) return false;
  }
  if (!ParseSlotList(r, &out->cached_slots)) return false;
  if (!ParseSlotList(r, &out->evict_slots)) return false;
  out->tune = r->u8() != 0;
  if (out->tune) {
    out->tune_commit = r->u8() != 0;
    out->tune_trial_id = r->vi();
    out->tune_chunk_bytes = r->vi();
    out->tune_fusion_threshold = r->vi();
    out->tune_cycle_time_ms = static_cast<int32_t>(r->vi());
    out->tune_wave_width = static_cast<int32_t>(r->vi());
    out->tune_algo_threshold = r->vi();
    out->tune_wire_dtype = static_cast<int32_t>(r->vi());
    out->tune_priority_bands = r->vi();
    uint64_t nl = r->vu();
    if (nl > 64) return false;  // corrupt frame guard
    out->tune_fusion_ladder.clear();
    for (uint64_t i = 0; i < nl && r->ok(); ++i) {
      out->tune_fusion_ladder.push_back(r->vi());
    }
  }
  uint64_t nps = r->vu();
  if (nps > (1u << 20)) return false;
  out->partial_slots.resize(nps);
  for (uint64_t i = 0; i < nps && r->ok(); ++i) {
    out->partial_slots[i].slot = static_cast<uint32_t>(r->vu());
    if (!ParseSlotBitvector(r, &out->partial_slots[i].participants)) {
      return false;
    }
  }
  // Trailing tagged sections (see the serializer).
  while (r->ok() && r->remaining() > 0) {
    uint8_t tag = r->u8();
    if (tag == 3) {
      uint64_t n = r->vu();
      if (n > (1u << 20)) return false;
      for (uint64_t i = 0; i < n && r->ok(); ++i) {
        uint64_t idx = r->vu();
        uint64_t prio = r->vu();
        if (idx >= out->responses.size() || prio > (1u << 30)) {
          return false;
        }
        out->responses[idx].priority = static_cast<int32_t>(prio);
      }
    } else {
      return false;  // unknown trailing section
    }
  }
  return r->ok();
}

// -- link self-healing handshake validation --
// The frames travel raw (fixed-width int64s, same build both ends); the
// magic check is what distinguishes a genuine RESUME/ACK from a stray
// connect's garbage or a truncated read filled with zeros.
bool ValidLinkResume(const LinkResume& r) {
  return r.magic == kLinkResumeMagic && r.origin >= 0 && r.ring >= 0 &&
         r.channel >= 0 && r.seq >= 0;
}

bool ValidLinkResumeAck(const LinkResumeAck& a) {
  return a.magic == kLinkAckMagic && (a.ok == 0 || a.ok == 1) &&
         a.step >= 0 && a.offset >= 0;
}

}  // namespace hvd
