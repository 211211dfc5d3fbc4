// Minimal TCP framing layer for the control and data planes.
//
// The reference delegates transport to MPI (MPI_Gather/Gatherv/Bcast for
// control, MPI_Allreduce/Allgatherv/Bcast for data).  The TPU-native
// runtime has no MPI: processes rendezvous at a coordinator address
// (the same model as the JAX distributed runtime) and exchange
// length-prefixed frames over TCP.  TCP_NODELAY is set everywhere —
// the control plane sends many tiny frames per cycle.
#pragma once

#include <cstdint>
#include <functional>
#include <string>
#include <vector>

namespace hvd {

class Socket {
 public:
  Socket() : fd_(-1) {}
  explicit Socket(int fd) : fd_(fd) {}
  ~Socket();
  Socket(const Socket&) = delete;
  Socket& operator=(const Socket&) = delete;
  Socket(Socket&& o) noexcept : fd_(o.fd_) { o.fd_ = -1; }
  Socket& operator=(Socket&& o) noexcept;

  bool valid() const { return fd_ >= 0; }
  int fd() const { return fd_; }
  void Close();

  // Robustness knobs (a hung-but-connected peer must not block forever —
  // the reference's stall story covers negotiation only; transport hangs
  // were invisible).  Timeout 0 = never time out.  Dead-peer detection
  // (keepalive + TCP_USER_TIMEOUT) is armed via ArmSocketDeadlines below.
  void SetTimeouts(int timeout_sec);
  // SO_SNDBUF/SO_RCVBUF for data-plane sockets (HOROVOD_SOCKET_BUF_BYTES).
  // Bigger buffers let the kernel keep the wire busy while userland is in
  // a reduction kernel — the cheap half of wire/compute overlap.  0 = keep
  // the kernel default.
  void SetBufSizes(int bytes);

  // Blocking helpers; return false on error/EOF/timeout.
  bool SendAll(const void* data, size_t n);
  bool RecvAll(void* data, size_t n);

  // RecvAll for store-and-forward waits (broadcast relays, hierarchical
  // chain hops) where zero bytes for a while can mean "upstream hops still
  // in flight", not "peer hung": tolerates up to `max_idle_rounds`
  // consecutive SO_RCVTIMEO expiries before failing; EOF / hard errors
  // still fail immediately.  A non-null `wait_label` names who is being
  // waited for in a stderr warning each idle round, so patience burns
  // visibly instead of reading as a hang.
  bool RecvAllPatient(void* data, size_t n, int max_idle_rounds,
                      const char* wait_label = nullptr);

  // Length-prefixed frames (u64 length + payload).  `max_idle_rounds` > 0
  // tolerates that many SO_RCVTIMEO expiries while waiting for the frame —
  // the control plane must ride out ranks that are legitimately busy
  // executing a long data-plane collective before their next cycle frame.
  bool SendFrame(const std::vector<uint8_t>& payload);
  bool RecvFrame(std::vector<uint8_t>* payload, int max_idle_rounds = 0,
                 const char* wait_label = nullptr);

 private:
  int fd_;
};

// Scoped O_NONBLOCK toggle: poll-multiplexed loops (SendRecvAll, the
// engine's streaming cascade) must not block inside send/recv/accept;
// the blocking mode is restored on destruction so the frame-based
// control plane keeps its simple blocking reads.
class NonblockGuard {
 public:
  explicit NonblockGuard(int fd);
  ~NonblockGuard();
  NonblockGuard(const NonblockGuard&) = delete;
  NonblockGuard& operator=(const NonblockGuard&) = delete;

 private:
  int fd_;
  int flags_;
};

// Full-duplex transfer: send `sn` bytes on `snd` while receiving `rn` bytes
// from `rcv`, multiplexed with poll(2) on nonblocking fds.  This replaces
// the thread-per-send pattern on the ring hot path (2(N-1) thread spawns
// per collective) with zero extra threads.  `timeout_ms` bounds the time
// with NO forward progress on either direction (<=0 = wait forever).  On
// failure fills *err with a message prefixed "send to peer:" or
// "recv from peer:" so the caller can name the guilty neighbor rank.
bool SendRecvAll(Socket& snd, const void* send_buf, size_t sn,
                 Socket& rcv, void* recv_buf, size_t rn,
                 int timeout_ms, std::string* err);

// SendRecvAll with chunk-pipelined receive processing: every time the
// receive side completes another `chunk` bytes (and once more for the
// final partial chunk), `on_chunk(offset, len)` is invoked from the same
// thread BEFORE the poll loop resumes.  While the callback runs (e.g. a
// ReduceInto of chunk k), the kernel keeps draining/filling both socket
// buffers, so wire time overlaps compute time without any extra thread —
// the ring-phase analogue of HierarchicalAllreduce's chunked local chain.
// `chunk == 0` (or >= rn) degenerates to one callback after the full
// receive.  When non-null, `wire_ns` accumulates time spent progressing
// the sockets (poll/send/recv, callback time excluded) so callers can
// split a collective's wall time into wire vs. reduce.
bool SendRecvChunked(Socket& snd, const void* send_buf, size_t sn,
                     Socket& rcv, void* recv_buf, size_t rn, size_t chunk,
                     const std::function<void(size_t, size_t)>& on_chunk,
                     int timeout_ms, std::string* err,
                     int64_t* wire_ns = nullptr);

// Listen on host:port (port 0 = ephemeral). Returns listening socket and
// fills *bound_port.
Socket Listen(const std::string& host, int port, int backlog,
              int* bound_port, std::string* error);
// Accept one connection.  Honors the listener's SetTimeouts bound
// (SO_RCVTIMEO applies to accept(2) on Linux): with a timeout set, an
// accept that sees no completed connection within the bound returns an
// invalid Socket with *error == kAcceptTimedOut — callers loop against
// their own deadline instead of wedging forever on a listener that a
// half-open or never-arriving connect left silent.
Socket Accept(Socket& listener, std::string* error);

// The distinguished Accept timeout error (deadline expiry, not a failure).
extern const char* const kAcceptTimedOut;

// True when the listener has a completed connection ready to accept RIGHT
// NOW (poll with zero timeout) — the coordinator's per-cycle probe for
// elastic mid-run join candidates; never blocks.
bool HasPendingConnection(Socket& listener);

// Accept a connection ONLY if one is ready right now (zero-timeout poll +
// nonblocking accept); invalid Socket otherwise.  The link-heal path's
// accept primitive: several channel drivers poll one shared data listener
// for RESUME re-handshakes, so a driver whose POLLIN lost the accept race
// must get "nothing" immediately, never block on the NEXT connection.
// Side effect: the listener is left PERMANENTLY nonblocking (per-call flag
// save/restore would race between concurrent drivers; hvd::Accept already
// tolerates a nonblocking listener).
Socket TryAcceptNow(Socket& listener);

// Nonblocking connect pair for poll-multiplexed loops (the link-heal
// re-dial must not park a channel driver for a connect timeout).
// ConnectStart resolves + starts the connect: on immediate completion
// returns a ready BLOCKING socket (*in_progress false); on EINPROGRESS
// returns the in-flight nonblocking socket (*in_progress true) — poll it
// for POLLOUT, then call ConnectFinish, which checks SO_ERROR and
// restores blocking mode on success.
Socket ConnectStart(const std::string& host, int port, bool* in_progress,
                    std::string* err);
bool ConnectFinish(Socket& s, std::string* err);

// Kernel-side dead-peer detection bound for a long-lived connection:
// SO_KEEPALIVE with probe timing that detects a dead-but-ESTABLISHED peer
// within ~min(30s, deadline_sec), plus TCP_USER_TIMEOUT = deadline_sec so
// unacknowledged SENT data errors the socket within the same bound (the
// half a silent keepalive cannot cover: keepalive probes only run on an
// idle connection).  deadline_sec <= 0 keeps the legacy ~30 s keepalive
// probing and sets no user timeout.  Shared by data sockets (aligned with
// HOROVOD_SOCKET_TIMEOUT_SEC, itself capped by the fault timeout) and
// control sockets (rendezvous/CTRL conns), so a dead peer surfaces as a
// socket ERROR inside the fault bound instead of only via the
// coordinator's patience.
void ArmSocketDeadlines(Socket& s, int deadline_sec);

// True when `s` becomes readable within timeout_ms (0 = only if readable
// right now).  Bounds a speculative read on a connection that may never
// send anything — e.g. a port scanner hitting the coordinator's listener.
bool WaitReadable(Socket& s, int timeout_ms);
// Connect with retry until deadline_ms elapses (peer may not be up yet).
Socket ConnectRetry(const std::string& host, int port, int deadline_ms,
                    std::string* error);

}  // namespace hvd
