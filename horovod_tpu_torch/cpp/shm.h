// Shared-memory transport for co-located ranks.
//
// The reference delegates intra-host transport to NCCL, which picks shm/P2P
// under the hood; this runtime's loopback-TCP ring is CPU-ceilinged on small
// hosts (~1.4 GB/s aggregate on the 2-core CI box) and every byte between
// same-host ranks paid syscall + copy tax twice.  ShmRing is the second
// channel kind of the data plane: a single-producer/single-consumer byte
// ring in a POSIX shm segment (/dev/shm), mapped by exactly two processes,
// with monotonic head/tail cursors and a futex wakeup — plus a
// spin-then-yield fallback, because sandboxed kernels have spotty syscall
// coverage (the gVisor accept(2)/SO_RCVTIMEO precedent; futex is probed at
// runtime, never assumed).
//
// Lifecycle is leak-proof by construction: the creator unlinks the segment
// the moment the attacher confirms its mapping (unlink-after-map — the
// mapping survives, the name does not), so a killed job leaves no /dev/shm
// entries behind for wired edges, and the coordinator sweeps the job's name
// prefix at every rendezvous so a crash DURING wiring is cleaned up by the
// next incarnation (elastic re-init, supervisor relaunch).
#pragma once

#include <atomic>
#include <cstdint>
#include <functional>
#include <string>

namespace hvd {

// Segment header, one page; the byte ring follows it.  head/tail are
// MONOTONIC byte counters (no wrap ambiguity): read avail = head - tail,
// write avail = capacity - (head - tail).  `seq` is the futex word — bumped
// by every publish/consume so a waiter can sleep on "no state change";
// `waiters` gates the wake syscall (the common case never pays it).
struct ShmRingHdr {
  uint32_t magic;
  uint32_t version;
  int64_t epoch;
  uint64_t capacity;
  alignas(64) std::atomic<uint64_t> head;      // producer-written
  alignas(64) std::atomic<uint64_t> tail;      // consumer-written
  alignas(64) std::atomic<uint32_t> seq;       // futex word (state changes)
  std::atomic<uint32_t> waiters;
  std::atomic<uint32_t> closed;                // either side's EOF/abort
  std::atomic<uint32_t> attached;              // attacher confirms mapping
};

// One direction of a co-located edge.  The CREATOR is always the PRODUCER
// (edge source); the attacher is the consumer — fixed roles keep the SPSC
// contract self-evident at every call site.
class ShmRing {
 public:
  ShmRing() = default;
  ~ShmRing() { Unmap(); }
  ShmRing(const ShmRing&) = delete;
  ShmRing& operator=(const ShmRing&) = delete;
  ShmRing(ShmRing&& o) noexcept { *this = std::move(o); }
  ShmRing& operator=(ShmRing&& o) noexcept;

  // Producer side: create the segment (unlinking any stale same-name file
  // first — names are epoch-stamped, so a live segment can never collide).
  bool Create(const std::string& name, uint64_t capacity, int64_t epoch,
              std::string* err);
  // Consumer side: attach, retrying until the creator's segment appears
  // (bounded by timeout_ms); validates magic + epoch, confirms the mapping
  // via hdr->attached so the creator can unlink.
  bool Attach(const std::string& name, int64_t epoch, int timeout_ms,
              std::string* err);
  // Producer side, post-wiring: wait for the attach confirmation, then
  // unlink the name (the mapping stays alive; the filesystem entry — the
  // only thing a kill could leak — is gone).  False on timeout.
  bool UnlinkAfterAttach(int timeout_ms);

  bool valid() const { return hdr_ != nullptr; }
  // Peer (or self) closed the ring — the shm analogue of TCP EOF.
  bool Closed() const {
    return hdr_ == nullptr || hdr_->closed.load(std::memory_order_acquire);
  }
  // Mark closed + wake any sleeper, so a blocked peer fails fast instead
  // of waiting out its timeout (Engine teardown calls this on every ring).
  void Close();
  void Unmap();

  uint64_t ReadAvail() const {
    return hdr_->head.load(std::memory_order_acquire) -
           hdr_->tail.load(std::memory_order_relaxed);
  }
  uint64_t WriteAvail() const {
    return hdr_->capacity - (hdr_->head.load(std::memory_order_relaxed) -
                             hdr_->tail.load(std::memory_order_acquire));
  }

  // Nonblocking SPSC transfers; return bytes moved (0 = full/empty).
  size_t TryWrite(const void* p, size_t n);
  size_t TryRead(void* p, size_t n);

  // Block (spin, then futex/yield) until data/space is available, the ring
  // closes, or timeout_ms of NO state change elapses (<= 0: wait forever).
  // True = condition may hold now; false = timeout or closed (check
  // Closed() to tell them apart).
  bool WaitReadable(int timeout_ms);
  bool WaitWritable(int timeout_ms);

  // Blocking whole-buffer helpers over the primitives above; on failure
  // *err says whether the peer closed or stalled past timeout_ms.
  bool WriteAll(const void* p, size_t n, int timeout_ms, std::string* err);
  bool ReadAll(void* p, size_t n, int timeout_ms, std::string* err);

  // One bounded sleep slice on "seq still == seen" (futex when the kernel
  // has one, a short nap otherwise).  Used by the wait loops; public so
  // free-function progress loops can park on a ring without friending.
  void WaitSeqSlice(uint32_t seen, int timeout_ms);

 private:
  void Bump();   // publish a state change: seq++ (+ futex wake if waited-on)

  ShmRingHdr* hdr_ = nullptr;
  uint8_t* data_ = nullptr;
  size_t map_len_ = 0;
  std::string name_;
  bool creator_ = false;
  bool unlinked_ = false;
};

// A duplex co-located edge: tx carries this rank's bytes toward the peer,
// rx the reverse direction (each an independently created/attached ring).
struct ShmEdge {
  ShmRing tx, rx;
  bool valid() const { return tx.valid() && rx.valid(); }
};

// Full-duplex chunked transfer over an edge — the shm analogue of
// SendRecvChunked (socket.h): stream sn bytes out and rn bytes in
// simultaneously, firing on_chunk(offset, len) as every completed `chunk`
// of the receive lands (0 = one callback at the end).  Spin-then-yield
// progress loop; timeout_ms bounds time with NO forward progress.  When
// non-null, wire_ns accumulates loop time minus callback time.
bool ShmSendRecvChunked(ShmRing& tx, const void* send_buf, size_t sn,
                        ShmRing& rx, void* recv_buf, size_t rn, size_t chunk,
                        const std::function<void(size_t, size_t)>& on_chunk,
                        int timeout_ms, std::string* err,
                        int64_t* wire_ns = nullptr);

// Unlink every /dev/shm entry whose name starts with `prefix`, except
// names containing `keep_substr` (when non-empty).  The coordinator calls
// this between the membership commit and the ASSIGN broadcast — no
// current-epoch segment exists yet (workers create edges only after
// ASSIGN), so everything matching is a dead incarnation's leftover from a
// crash mid-wiring.  Group leaders on other hosts sweep during wiring and
// pass the current epoch tag as `keep_substr` so live peers' fresh
// segments survive.  Returns the number unlinked.
int ShmSweepStale(const std::string& prefix,
                  const std::string& keep_substr = std::string());

// One-shot runtime probe: can this host create + map + unlink a segment?
// The coordinator folds the answer into the committed shm_enabled flag so
// every rank agrees on the transport (a per-rank fallback would desync the
// wire pattern).
bool ShmAvailable();

}  // namespace hvd
