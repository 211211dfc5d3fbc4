#include "flightrec.h"

#include <cstdarg>
#include <cstdio>
#include <cstring>
#include <chrono>
#include <ctime>

#include <fcntl.h>
#include <signal.h>
#include <unistd.h>

namespace hvd {

static int64_t MonoNs() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void FlightRecorder::Configure(int capacity, const std::string& dir,
                               int rank, int64_t epoch,
                               int64_t clock_offset_ns) {
  // Re-Init (elastic recovery) reconfigures identity but keeps the ring
  // and its history: the events leading INTO an abort are exactly what
  // the post-mortem wants, and a fresh epoch is itself recorded by the
  // caller as an "epoch" event.
  rank_ = rank;
  epoch_ = epoch;
  clock_offset_ns_ = clock_offset_ns;
  std::snprintf(dir_, sizeof(dir_), "%s", dir.c_str());
  if (ring_ == nullptr && capacity > 0) {
    if (capacity > (1 << 16)) capacity = 1 << 16;
    ring_ = new Event[capacity];
    capacity_ = capacity;
  }
}

FlightRecorder::~FlightRecorder() { delete[] ring_; }

void FlightRecorder::Record(const char* kind, int64_t cycle,
                            const char* fmt, ...) {
  if (capacity_ <= 0) return;
  // The recorder is effectively single-writer (the background thread);
  // the spin guard only defends against a racing manual dump.
  while (lock_.test_and_set(std::memory_order_acquire)) {
  }
  int64_t seq = seq_.fetch_add(1);
  Event& e = ring_[seq % capacity_];
  e.seq = seq;
  e.mono_ns = MonoNs();
  e.cycle = cycle;
  std::snprintf(e.kind, sizeof(e.kind), "%s", kind);
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(e.text, sizeof(e.text), fmt, ap);
  va_end(ap);
  // JSON-proof the text in place: the dump path must not allocate, so
  // escaping happens at record time (quotes/backslashes/control chars
  // become spaces — forensics text, not payload).
  for (char* p = e.text; *p; ++p) {
    if (*p == '"' || *p == '\\' || static_cast<unsigned char>(*p) < 0x20) {
      *p = ' ';
    }
  }
  lock_.clear(std::memory_order_release);
}

int FlightRecorder::Dump(const char* reason, bool signal_safe) {
  if (capacity_ <= 0 || dir_[0] == '\0') return -1;
  if (!signal_safe) {
    while (lock_.test_and_set(std::memory_order_acquire)) {
    }
  }
  char path[320], tmp[336];
  std::snprintf(path, sizeof(path), "%s/flightrec.rank%d.json", dir_,
                rank_);
  std::snprintf(tmp, sizeof(tmp), "%s.tmp", path);
  int fd = ::open(tmp, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) {
    if (!signal_safe) lock_.clear(std::memory_order_release);
    return -1;
  }
  char buf[512];
  char esc_reason[256];
  std::snprintf(esc_reason, sizeof(esc_reason), "%s",
                reason ? reason : "");
  for (char* p = esc_reason; *p; ++p) {
    if (*p == '"' || *p == '\\' || static_cast<unsigned char>(*p) < 0x20) {
      *p = ' ';
    }
  }
  int n = std::snprintf(
      buf, sizeof(buf),
      "{\"rank\": %d, \"epoch\": %lld, \"clock_offset_ns\": %lld, "
      "\"dump_mono_ns\": %lld, \"dump_unix_sec\": %lld, "
      "\"reason\": \"%s\", \"events\": [\n",
      rank_, static_cast<long long>(epoch_),
      static_cast<long long>(clock_offset_ns_),
      static_cast<long long>(MonoNs()),
      static_cast<long long>(::time(nullptr)), esc_reason);
  (void)!::write(fd, buf, n);
  const int64_t seq = seq_.load();
  const int64_t count = seq < capacity_ ? seq : capacity_;
  const int64_t first = seq - count;
  for (int64_t s = first; s < seq; ++s) {
    const Event& e = ring_[s % capacity_];
    n = std::snprintf(
        buf, sizeof(buf),
        "{\"seq\": %lld, \"mono_ns\": %lld, \"cycle\": %lld, "
        "\"kind\": \"%s\", \"text\": \"%s\"}%s\n",
        static_cast<long long>(e.seq), static_cast<long long>(e.mono_ns),
        static_cast<long long>(e.cycle), e.kind, e.text,
        s + 1 < seq ? "," : "");
    (void)!::write(fd, buf, n);
  }
  (void)!::write(fd, "]}\n", 3);
  ::close(fd);
  int rc = ::rename(tmp, path);
  dumps_.fetch_add(1);
  if (!signal_safe) lock_.clear(std::memory_order_release);
  return rc == 0 ? 0 : -1;
}

FlightRecorder& GlobalFlightRecorder() {
  static FlightRecorder* rec = new FlightRecorder();
  return *rec;
}

static void FlightSignalHandler(int sig) {
  // Best-effort crash dump: only open/write/rename after snprintf
  // formatting (practically safe; a crash here loses nothing the crash
  // itself wasn't already losing), then re-raise the default action so
  // exit codes and core dumps behave exactly as without the handler.
  const char* name = sig == SIGSEGV ? "SIGSEGV"
                     : sig == SIGBUS ? "SIGBUS"
                     : sig == SIGFPE ? "SIGFPE"
                     : sig == SIGABRT ? "SIGABRT"
                     : sig == SIGTERM ? "SIGTERM"
                                      : "signal";
  char reason[64];
  std::snprintf(reason, sizeof(reason), "fatal signal %s", name);
  GlobalFlightRecorder().Dump(reason, /*signal_safe=*/true);
  ::signal(sig, SIG_DFL);
  ::raise(sig);
}

void InstallFlightSignalHandlers() {
  static bool installed = false;
  if (installed) return;
  installed = true;
  struct sigaction sa;
  std::memset(&sa, 0, sizeof(sa));
  sa.sa_handler = FlightSignalHandler;
  sigemptyset(&sa.sa_mask);
  sa.sa_flags = SA_RESETHAND;
  for (int sig : {SIGSEGV, SIGBUS, SIGFPE, SIGABRT, SIGTERM}) {
    struct sigaction old;
    std::memset(&old, 0, sizeof(old));
    ::sigaction(sig, nullptr, &old);
    // Never displace a non-default disposition someone else installed
    // (Python's SIGTERM handling, a test harness, faulthandler).
    if (old.sa_handler == SIG_DFL) ::sigaction(sig, &sa, nullptr);
  }
}

}  // namespace hvd
