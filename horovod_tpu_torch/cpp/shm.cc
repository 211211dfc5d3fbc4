#include "shm.h"

#include <dirent.h>
#include <fcntl.h>
#include <linux/futex.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#include <cerrno>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>

namespace hvd {

static constexpr uint32_t kShmMagic = 0x4d535648u;  // "HVSM"
static constexpr uint32_t kShmVersion = 1;
static constexpr size_t kHdrBytes = 4096;  // one page keeps the data aligned

// Spin budget before sleeping: co-located peers answer in microseconds, so
// a short spin wins the latency case while the futex bounds the burn when
// the peer is genuinely busy.  HOROVOD_SHM_SPIN overrides (0 = no spin).
static int SpinIters() {
  static const int iters = [] {
    const char* v = std::getenv("HOROVOD_SHM_SPIN");
    if (v != nullptr && v[0] != '\0') {
      long n = std::strtol(v, nullptr, 10);
      return static_cast<int>(n < 0 ? 0 : n);
    }
    return 4000;
  }();
  return iters;
}

// futex(2) probed once: sandboxed kernels with partial coverage degrade to
// the yield/sleep fallback instead of failing transfers.
static bool FutexWorks() {
  static const bool ok = [] {
    uint32_t word = 1;
    // FUTEX_WAIT with a mismatched expected value must return EAGAIN
    // immediately on a working implementation.
    long rc = syscall(SYS_futex, &word, FUTEX_WAIT, 0u, nullptr, nullptr, 0);
    return rc == -1 && errno == EAGAIN;
  }();
  return ok;
}

static void FutexWaitSlice(std::atomic<uint32_t>* word, uint32_t expect,
                           int ms) {
  timespec ts{ms / 1000, static_cast<long>(ms % 1000) * 1000000};
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(word), FUTEX_WAIT, expect,
          &ts, nullptr, 0);
}

static void FutexWakeAll(std::atomic<uint32_t>* word) {
  syscall(SYS_futex, reinterpret_cast<uint32_t*>(word), FUTEX_WAKE,
          0x7fffffff, nullptr, nullptr, 0);
}

ShmRing& ShmRing::operator=(ShmRing&& o) noexcept {
  if (this != &o) {
    Unmap();
    hdr_ = o.hdr_;
    data_ = o.data_;
    map_len_ = o.map_len_;
    name_ = std::move(o.name_);
    creator_ = o.creator_;
    unlinked_ = o.unlinked_;
    o.hdr_ = nullptr;
    o.data_ = nullptr;
    o.map_len_ = 0;
    o.unlinked_ = true;
  }
  return *this;
}

bool ShmRing::Create(const std::string& name, uint64_t capacity,
                     int64_t epoch, std::string* err) {
  Unmap();
  // Stale same-name file (a crash mid-wiring in a dead incarnation that
  // happened to reuse the epoch counter): the name is ours to claim.
  ::shm_unlink(name.c_str());
  int fd = ::shm_open(name.c_str(), O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    *err = "shm_open(" + name + "): " + strerror(errno);
    return false;
  }
  size_t len = kHdrBytes + capacity;
  if (::ftruncate(fd, static_cast<off_t>(len)) != 0) {
    *err = "ftruncate(" + name + "): " + strerror(errno) +
           " — is /dev/shm full? see docs/troubleshooting.md";
    ::close(fd);
    ::shm_unlink(name.c_str());
    return false;
  }
  void* p = ::mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  ::close(fd);
  if (p == MAP_FAILED) {
    *err = "mmap(" + name + "): " + strerror(errno);
    ::shm_unlink(name.c_str());
    return false;
  }
  hdr_ = new (p) ShmRingHdr();
  hdr_->magic = 0;  // published last, after the fields below are in place
  hdr_->version = kShmVersion;
  hdr_->epoch = epoch;
  hdr_->capacity = capacity;
  hdr_->head.store(0);
  hdr_->tail.store(0);
  hdr_->seq.store(0);
  hdr_->waiters.store(0);
  hdr_->closed.store(0);
  hdr_->attached.store(0);
  std::atomic_thread_fence(std::memory_order_release);
  hdr_->magic = kShmMagic;
  data_ = static_cast<uint8_t*>(p) + kHdrBytes;
  map_len_ = len;
  name_ = name;
  creator_ = true;
  unlinked_ = false;
  return true;
}

bool ShmRing::Attach(const std::string& name, int64_t epoch, int timeout_ms,
                     std::string* err) {
  Unmap();
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (true) {
    int fd = ::shm_open(name.c_str(), O_RDWR, 0600);
    if (fd >= 0) {
      struct stat st {};
      if (::fstat(fd, &st) == 0 &&
          st.st_size > static_cast<off_t>(kHdrBytes)) {
        size_t len = static_cast<size_t>(st.st_size);
        void* p =
            ::mmap(nullptr, len, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
        ::close(fd);
        if (p == MAP_FAILED) {
          *err = "mmap(" + name + "): " + strerror(errno);
          return false;
        }
        ShmRingHdr* hdr = static_cast<ShmRingHdr*>(p);
        if (hdr->magic == kShmMagic && hdr->version == kShmVersion &&
            hdr->epoch == epoch &&
            len == kHdrBytes + hdr->capacity) {
          hdr_ = hdr;
          data_ = static_cast<uint8_t*>(p) + kHdrBytes;
          map_len_ = len;
          name_ = name;
          creator_ = false;
          unlinked_ = true;  // the creator owns the name
          hdr_->attached.store(1, std::memory_order_release);
          FutexWakeAll(&hdr_->seq);
          return true;
        }
        // Stale/mismatched segment (an older epoch's leftover the creator
        // is about to replace): unmap and keep retrying until the real one
        // appears.
        ::munmap(p, len);
      } else {
        ::close(fd);
      }
    }
    if (std::chrono::steady_clock::now() > deadline) {
      *err = "shm attach timed out waiting for " + name +
             " — the peer likely died during wiring";
      return false;
    }
    std::this_thread::sleep_for(std::chrono::milliseconds(2));
  }
}

bool ShmRing::UnlinkAfterAttach(int timeout_ms) {
  if (hdr_ == nullptr || !creator_ || unlinked_) return unlinked_;
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(timeout_ms);
  while (!hdr_->attached.load(std::memory_order_acquire)) {
    if (std::chrono::steady_clock::now() > deadline) return false;
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  ::shm_unlink(name_.c_str());
  unlinked_ = true;
  return true;
}

void ShmRing::Close() {
  if (hdr_ == nullptr) return;
  hdr_->closed.store(1, std::memory_order_release);
  Bump();
  FutexWakeAll(&hdr_->seq);  // wake unconditionally: teardown is rare
}

void ShmRing::Unmap() {
  if (hdr_ == nullptr) return;
  if (creator_ && !unlinked_) {
    // Wiring never completed (init failure): drop the name so nothing
    // leaks; the coordinator's sweep is the backstop, not the norm.
    ::shm_unlink(name_.c_str());
    unlinked_ = true;
  }
  ::munmap(hdr_, map_len_);
  hdr_ = nullptr;
  data_ = nullptr;
  map_len_ = 0;
}

void ShmRing::Bump() {
  hdr_->seq.fetch_add(1, std::memory_order_acq_rel);
  if (hdr_->waiters.load(std::memory_order_acquire) != 0) {
    FutexWakeAll(&hdr_->seq);
  }
}

size_t ShmRing::TryWrite(const void* p, size_t n) {
  uint64_t head = hdr_->head.load(std::memory_order_relaxed);
  uint64_t tail = hdr_->tail.load(std::memory_order_acquire);
  uint64_t space = hdr_->capacity - (head - tail);
  if (space == 0 || n == 0) return 0;
  size_t k = static_cast<size_t>(space < n ? space : n);
  uint64_t off = head % hdr_->capacity;
  size_t first = static_cast<size_t>(
      hdr_->capacity - off < k ? hdr_->capacity - off : k);
  memcpy(data_ + off, p, first);
  if (k > first) {
    memcpy(data_, static_cast<const uint8_t*>(p) + first, k - first);
  }
  hdr_->head.store(head + k, std::memory_order_release);
  Bump();
  return k;
}

size_t ShmRing::TryRead(void* p, size_t n) {
  uint64_t head = hdr_->head.load(std::memory_order_acquire);
  uint64_t tail = hdr_->tail.load(std::memory_order_relaxed);
  uint64_t avail = head - tail;
  if (avail == 0 || n == 0) return 0;
  size_t k = static_cast<size_t>(avail < n ? avail : n);
  uint64_t off = tail % hdr_->capacity;
  size_t first = static_cast<size_t>(
      hdr_->capacity - off < k ? hdr_->capacity - off : k);
  memcpy(p, data_ + off, first);
  if (k > first) {
    memcpy(static_cast<uint8_t*>(p) + first, data_, k - first);
  }
  hdr_->tail.store(tail + k, std::memory_order_release);
  Bump();
  return k;
}

void ShmRing::WaitSeqSlice(uint32_t seen, int timeout_ms) {
  if (FutexWorks()) {
    hdr_->waiters.fetch_add(1, std::memory_order_acq_rel);
    if (hdr_->seq.load(std::memory_order_acquire) == seen &&
        !Closed()) {
      FutexWaitSlice(&hdr_->seq, seen, timeout_ms);
    }
    hdr_->waiters.fetch_sub(1, std::memory_order_acq_rel);
  } else {
    // Spin-then-yield fallback for kernels without a working futex: sleep
    // a short slice — correctness never depends on the wakeup, only
    // latency does.
    std::this_thread::sleep_for(std::chrono::microseconds(200));
  }
}

template <typename Avail>
static bool WaitCond(ShmRing* ring, ShmRingHdr* hdr, Avail avail,
                     int timeout_ms) {
  // One progress bound: `timeout_ms` of NO seq movement (not total wait —
  // a peer legitimately mid-collective keeps bumping seq).
  int spin = SpinIters();
  auto last_change = std::chrono::steady_clock::now();
  uint32_t seen = hdr->seq.load(std::memory_order_acquire);
  for (int i = 0;; ++i) {
    if (avail() > 0) return true;
    if (ring->Closed()) return false;
    uint32_t now_seq = hdr->seq.load(std::memory_order_acquire);
    if (now_seq != seen) {
      seen = now_seq;
      last_change = std::chrono::steady_clock::now();
      continue;
    }
    if (timeout_ms > 0 &&
        std::chrono::steady_clock::now() - last_change >
            std::chrono::milliseconds(timeout_ms)) {
      return false;
    }
    if (i < spin) {
#if defined(__x86_64__)
      __builtin_ia32_pause();
#endif
      continue;
    }
    if (i < spin + 64) {
      std::this_thread::yield();
      continue;
    }
    ring->WaitSeqSlice(seen, 10);
  }
}

bool ShmRing::WaitReadable(int timeout_ms) {
  if (hdr_ == nullptr) return false;
  return WaitCond(this, hdr_, [&] { return ReadAvail(); }, timeout_ms);
}

bool ShmRing::WaitWritable(int timeout_ms) {
  if (hdr_ == nullptr) return false;
  return WaitCond(this, hdr_, [&] { return WriteAvail(); }, timeout_ms);
}

bool ShmRing::WriteAll(const void* p, size_t n, int timeout_ms,
                       std::string* err) {
  const uint8_t* b = static_cast<const uint8_t*>(p);
  while (n > 0) {
    size_t k = TryWrite(b, n);
    if (k == 0) {
      if (Closed()) {
        *err = "send to peer: shm ring closed (peer exited?)";
        return false;
      }
      if (!WaitWritable(timeout_ms)) {
        *err = Closed() ? "send to peer: shm ring closed (peer exited?)"
                        : "send to peer: shm no progress for " +
                              std::to_string(timeout_ms / 1000) +
                              "s (peer hung?)";
        return false;
      }
      continue;
    }
    b += k;
    n -= k;
  }
  return true;
}

bool ShmRing::ReadAll(void* p, size_t n, int timeout_ms, std::string* err) {
  uint8_t* b = static_cast<uint8_t*>(p);
  while (n > 0) {
    size_t k = TryRead(b, n);
    if (k == 0) {
      // Drain-before-close: bytes already in the ring stay readable after
      // a Close, so only an EMPTY closed ring is EOF.
      if (Closed() && ReadAvail() == 0) {
        *err = "recv from peer: shm ring closed (peer exited?)";
        return false;
      }
      if (!WaitReadable(timeout_ms)) {
        *err = Closed() ? "recv from peer: shm ring closed (peer exited?)"
                        : "recv from peer: shm no progress for " +
                              std::to_string(timeout_ms / 1000) +
                              "s (peer hung?)";
        return false;
      }
      continue;
    }
    b += k;
    n -= k;
  }
  return true;
}

bool ShmSendRecvChunked(ShmRing& tx, const void* send_buf, size_t sn,
                        ShmRing& rx, void* recv_buf, size_t rn, size_t chunk,
                        const std::function<void(size_t, size_t)>& on_chunk,
                        int timeout_ms, std::string* err, int64_t* wire_ns) {
  const uint8_t* sp = static_cast<const uint8_t*>(send_buf);
  uint8_t* rp = static_cast<uint8_t*>(recv_buf);
  const size_t rtotal = rn;
  size_t delivered = 0;
  if (chunk == 0) chunk = rtotal;
  const int spin = SpinIters();
  auto t0 = std::chrono::steady_clock::now();
  auto last_progress = t0;
  int64_t cb_ns = 0;
  int idle = 0;
  while (sn > 0 || rn > 0) {
    bool progress = false;
    if (sn > 0) {
      size_t k = tx.TryWrite(sp, sn);
      if (k > 0) {
        sp += k;
        sn -= k;
        progress = true;
      } else if (tx.Closed()) {
        *err = "send to peer: shm ring closed (peer exited?)";
        return false;
      }
    }
    if (rn > 0) {
      size_t k = rx.TryRead(rp, rn);
      if (k > 0) {
        rp += k;
        rn -= k;
        progress = true;
        if (on_chunk) {
          size_t done = rtotal - rn;
          while (delivered < done &&
                 (done - delivered >= chunk || rn == 0)) {
            size_t len = chunk < done - delivered ? chunk : done - delivered;
            auto c0 = std::chrono::steady_clock::now();
            on_chunk(delivered, len);
            cb_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                         std::chrono::steady_clock::now() - c0)
                         .count();
            delivered += len;
          }
        }
      } else if (rx.Closed() && rx.ReadAvail() == 0) {
        *err = "recv from peer: shm ring closed (peer exited?)";
        return false;
      }
    }
    if (progress) {
      idle = 0;
      last_progress = std::chrono::steady_clock::now();
      continue;
    }
    if (timeout_ms > 0 &&
        std::chrono::steady_clock::now() - last_progress >
            std::chrono::milliseconds(timeout_ms)) {
      *err = "link: shm no progress for " +
             std::to_string(timeout_ms / 1000) + "s (peer hung?)";
      return false;
    }
    ++idle;
    if (idle < spin) {
#if defined(__x86_64__)
      __builtin_ia32_pause();
#endif
    } else if (idle < spin + 64) {
      std::this_thread::yield();
    } else {
      // Bounded nap: with both directions pending we cannot futex-wait on
      // two words at once; the slice is short enough that throughput never
      // notices and long enough that an idle wait stops burning the core.
      std::this_thread::sleep_for(std::chrono::microseconds(100));
    }
  }
  if (wire_ns != nullptr) {
    *wire_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                    std::chrono::steady_clock::now() - t0)
                    .count() -
                cb_ns;
  }
  return true;
}

int ShmSweepStale(const std::string& prefix,
                  const std::string& keep_substr) {
  DIR* d = ::opendir("/dev/shm");
  if (d == nullptr) return 0;
  int n = 0;
  while (dirent* e = ::readdir(d)) {
    if (strncmp(e->d_name, prefix.c_str(), prefix.size()) == 0) {
      if (!keep_substr.empty() &&
          strstr(e->d_name, keep_substr.c_str()) != nullptr) {
        continue;  // a live peer's current-epoch segment mid-wiring
      }
      std::string name = "/";
      name += e->d_name;
      if (::shm_unlink(name.c_str()) == 0) ++n;
    }
  }
  ::closedir(d);
  if (n > 0) {
    std::fprintf(stderr,
                 "horovod_tpu: swept %d stale shm segment(s) with prefix "
                 "%s\n",
                 n, prefix.c_str());
  }
  return n;
}

bool ShmAvailable() {
  static const bool ok = [] {
    char name[64];
    std::snprintf(name, sizeof(name), "/hvd_probe_%d", ::getpid());
    ::shm_unlink(name);
    int fd = ::shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
    if (fd < 0) return false;
    bool good = ::ftruncate(fd, 4096) == 0;
    void* p = good ? ::mmap(nullptr, 4096, PROT_READ | PROT_WRITE,
                            MAP_SHARED, fd, 0)
                   : MAP_FAILED;
    if (p != MAP_FAILED) ::munmap(p, 4096);
    ::close(fd);
    ::shm_unlink(name);
    return good && p != MAP_FAILED;
  }();
  return ok;
}

}  // namespace hvd
