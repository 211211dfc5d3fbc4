// Control-plane flight recorder: a fixed-size in-memory ring of the last
// HOROVOD_FLIGHT_RECORDER_EVENTS control-plane events per rank (cycle
// summaries, response commits, cache evictions, partial commits, TUNE
// applies, epoch moves, stall warnings, abort verdicts), dumped
// atomically to HOROVOD_FLIGHT_RECORDER_DIR as
// ``flightrec.rank<r>.json`` on abort, stall-warning escalation, and
// fatal signals — the post-mortem CLI
// (``python -m horovod_tpu.monitor.postmortem``) cross-correlates the
// per-rank dumps and names the divergence point.
//
// Constraints that shape the design:
//   * recording happens on the background (control) thread every payload
//     cycle — it must be a couple of snprintf's into preallocated
//     fixed-size slots, never an allocation;
//   * the fatal-signal dump path cannot malloc or take a blocking lock —
//     events are POD, the writer is open/write/rename, and the ring lock
//     is a try-spin that the signal path simply skips (a torn in-flight
//     event is acceptable in a crash dump; a hang is not).
#pragma once

#include <atomic>
#include <cstdint>
#include <string>

namespace hvd {

class FlightRecorder {
 public:
  // kinds are short stable strings the post-mortem CLI switches on.
  static constexpr int kKindLen = 16;
  static constexpr int kTextLen = 168;
  struct Event {
    int64_t seq = 0;        // global record sequence (gap-free per rank)
    int64_t mono_ns = 0;    // steady_clock since an arbitrary epoch
    int64_t cycle = 0;      // control-plane cycle counter at record time
    char kind[kKindLen] = {0};
    char text[kTextLen] = {0};
  };

  // capacity <= 0 disables recording entirely; dir may be empty
  // (recording without a dump sink still feeds horovod_flight_events).
  void Configure(int capacity, const std::string& dir, int rank,
                 int64_t epoch, int64_t clock_offset_ns);
  bool enabled() const { return capacity_ > 0; }
  int64_t events_recorded() const { return seq_.load(); }
  int64_t dumps_written() const { return dumps_.load(); }

  // printf-style, truncating at kTextLen.  Cheap no-op when disabled.
  void Record(const char* kind, int64_t cycle, const char* fmt, ...)
      __attribute__((format(printf, 4, 5)));

  // Write the ring to <dir>/flightrec.rank<r>.json (tmp + rename).
  // `reason` lands in the dump header.  signal_safe=true skips the lock
  // and uses only async-signal-safe syscalls after the formatting.
  // Returns 0 on success, -1 when disabled/no dir/IO failure.  Repeated
  // dumps overwrite (the latest state wins).
  int Dump(const char* reason, bool signal_safe = false);

  ~FlightRecorder();

 private:
  Event* ring_ = nullptr;
  int capacity_ = 0;
  int rank_ = 0;
  int64_t epoch_ = 0;
  int64_t clock_offset_ns_ = 0;
  char dir_[256] = {0};
  std::atomic<int64_t> seq_{0};
  std::atomic<int64_t> dumps_{0};
  // Spin guard for slot formatting; Dump(signal_safe) skips it.
  std::atomic_flag lock_ = ATOMIC_FLAG_INIT;
};

// Process-wide recorder (the engine singleton's lifetime matches the
// process; the fatal-signal handler needs a global to reach).
FlightRecorder& GlobalFlightRecorder();

// Install SIGSEGV/SIGBUS/SIGFPE/SIGABRT/SIGTERM handlers that dump the
// recorder before re-raising the default action.  Idempotent.
void InstallFlightSignalHandlers();

}  // namespace hvd
