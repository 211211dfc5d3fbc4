#include "socket.h"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <cstring>
#include <thread>

namespace hvd {

Socket::~Socket() { Close(); }

Socket& Socket::operator=(Socket&& o) noexcept {
  if (this != &o) {
    Close();
    fd_ = o.fd_;
    o.fd_ = -1;
  }
  return *this;
}

void Socket::Close() {
  if (fd_ >= 0) {
    ::close(fd_);
    fd_ = -1;
  }
}

void Socket::SetTimeouts(int timeout_sec) {
  if (fd_ < 0 || timeout_sec <= 0) return;
  timeval tv{};
  tv.tv_sec = timeout_sec;
  ::setsockopt(fd_, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd_, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

void Socket::SetBufSizes(int bytes) {
  if (fd_ < 0 || bytes <= 0) return;
  ::setsockopt(fd_, SOL_SOCKET, SO_SNDBUF, &bytes, sizeof(bytes));
  ::setsockopt(fd_, SOL_SOCKET, SO_RCVBUF, &bytes, sizeof(bytes));
}

bool Socket::SendAll(const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n > 0) {
    ssize_t sent = ::send(fd_, p, n, MSG_NOSIGNAL);
    if (sent <= 0) {
      if (sent < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += sent;
    n -= static_cast<size_t>(sent);
  }
  return true;
}

bool Socket::RecvAll(void* data, size_t n) {
  char* p = static_cast<char*>(data);
  while (n > 0) {
    ssize_t got = ::recv(fd_, p, n, 0);
    if (got <= 0) {
      if (got < 0 && errno == EINTR) continue;
      return false;
    }
    p += got;
    n -= static_cast<size_t>(got);
  }
  return true;
}

bool Socket::RecvAllPatient(void* data, size_t n, int max_idle_rounds,
                            const char* wait_label) {
  char* p = static_cast<char*>(data);
  int idle = 0;
  while (n > 0) {
    ssize_t got = ::recv(fd_, p, n, 0);
    if (got <= 0) {
      if (got < 0 && errno == EINTR) continue;
      if (got < 0 && (errno == EAGAIN || errno == EWOULDBLOCK) &&
          ++idle <= max_idle_rounds) {
        // Burn patience LOUDLY: a wedged-but-alive peer can hold the
        // control plane for minutes before the descriptive abort, and a
        // silent wait reads as a hang (reference stall-warning cadence,
        // operations.cc:1366-1412, applied to transport waits).
        if (wait_label != nullptr) {
          std::fprintf(stderr,
                       "horovod_tpu: still waiting on %s (idle timeout "
                       "%d/%d before abort)\n",
                       wait_label, idle, max_idle_rounds);
        }
        continue;  // waiting its turn in the relay chain, peer still alive
      }
      return false;
    }
    idle = 0;
    p += got;
    n -= static_cast<size_t>(got);
  }
  return true;
}

bool Socket::SendFrame(const std::vector<uint8_t>& payload) {
  uint64_t len = payload.size();
  if (!SendAll(&len, sizeof(len))) return false;
  if (len == 0) return true;
  return SendAll(payload.data(), payload.size());
}

bool Socket::RecvFrame(std::vector<uint8_t>* payload, int max_idle_rounds,
                       const char* wait_label) {
  uint64_t len = 0;
  if (!RecvAllPatient(&len, sizeof(len), max_idle_rounds, wait_label)) {
    return false;
  }
  if (len > (1ull << 34)) return false;  // 16 GB sanity cap
  payload->resize(len);
  if (len == 0) return true;
  return RecvAll(payload->data(), len);
}

static void SetNoDelay(int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

// Shared IPv4 resolve (literal first, gethostbyname fallback) for the
// connect paths.  NOTE: gethostbyname is not thread-safe; in this stack
// hosts are near-always IP literals (the peer table carries what workers
// reported), so the fallback only runs on cold non-literal paths.
static bool ResolveIPv4(const std::string& host, in_addr* out,
                        std::string* err) {
  if (::inet_pton(AF_INET, host.c_str(), out) == 1) return true;
  hostent* he = ::gethostbyname(host.c_str());
  if (he == nullptr || he->h_addr_list[0] == nullptr) {
    *err = "cannot resolve host " + host;
    return false;
  }
  memcpy(out, he->h_addr_list[0], sizeof(*out));
  return true;
}

NonblockGuard::NonblockGuard(int fd)
    : fd_(fd), flags_(::fcntl(fd, F_GETFL, 0)) {
  if (flags_ >= 0) ::fcntl(fd_, F_SETFL, flags_ | O_NONBLOCK);
}

NonblockGuard::~NonblockGuard() {
  if (flags_ >= 0) ::fcntl(fd_, F_SETFL, flags_);
}

Socket Listen(const std::string& host, int port, int backlog,
              int* bound_port, std::string* error) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    *error = std::string("socket: ") + strerror(errno);
    return Socket();
  }
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (host.empty() || host == "0.0.0.0") {
    addr.sin_addr.s_addr = INADDR_ANY;
  } else if (!ResolveIPv4(host, &addr.sin_addr, error)) {
    ::close(fd);
    return Socket();
  }
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    *error = std::string("bind: ") + strerror(errno);
    ::close(fd);
    return Socket();
  }
  if (::listen(fd, backlog) != 0) {
    *error = std::string("listen: ") + strerror(errno);
    ::close(fd);
    return Socket();
  }
  if (bound_port != nullptr) {
    sockaddr_in got{};
    socklen_t len = sizeof(got);
    ::getsockname(fd, reinterpret_cast<sockaddr*>(&got), &len);
    *bound_port = ntohs(got.sin_port);
  }
  return Socket(fd);
}

const char* const kAcceptTimedOut =
    "accept: timed out waiting for an incoming connection";

Socket Accept(Socket& listener, std::string* error) {
  // Enforce the listener's SetTimeouts bound with poll(2), NOT the
  // kernel's SO_RCVTIMEO-on-accept behavior: sandboxed/older kernels
  // (e.g. gVisor) silently ignore the latter, which turned every
  // "bounded" rendezvous accept into an unbounded block — the exact
  // half-open-connect wedge this timeout exists to prevent.
  timeval tv{};
  socklen_t tvlen = sizeof(tv);
  int timeout_ms = -1;  // no timeout configured: block indefinitely
  if (::getsockopt(listener.fd(), SOL_SOCKET, SO_RCVTIMEO, &tv, &tvlen) == 0
      && (tv.tv_sec > 0 || tv.tv_usec > 0)) {
    timeout_ms = static_cast<int>(tv.tv_sec * 1000 + tv.tv_usec / 1000);
  }
  // The accept itself runs nonblocking: a connection that poll reported
  // can be reset before accept(2) picks it up (the classic poll/accept
  // race, accept(2) BUGS), and a blocking accept would then wait for the
  // NEXT connection — unbounded, on kernels that ignore SO_RCVTIMEO.
  NonblockGuard nb(listener.fd());
  while (true) {
    pollfd pfd{listener.fd(), POLLIN, 0};
    int rc = ::poll(&pfd, 1, timeout_ms);
    if (rc < 0) {
      if (errno == EINTR) continue;
      *error = std::string("accept poll: ") + strerror(errno);
      return Socket();
    }
    if (rc == 0) {
      // Deadline tick, not a failure — surface it distinctly so
      // rendezvous loops re-check their own deadline instead of
      // mistaking the expiry for a broken listener.
      *error = kAcceptTimedOut;
      return Socket();
    }
    int fd = ::accept(listener.fd(), nullptr, nullptr);
    if (fd >= 0) {
      SetNoDelay(fd);
      return Socket(fd);
    }
    if (errno == EINTR || errno == EAGAIN || errno == EWOULDBLOCK) {
      continue;  // the pending connection vanished (reset before accept)
    }
    *error = std::string("accept: ") + strerror(errno);
    return Socket();
  }
}

bool WaitReadable(Socket& s, int timeout_ms) {
  if (!s.valid()) return false;
  pollfd pfd{s.fd(), POLLIN, 0};
  return ::poll(&pfd, 1, timeout_ms) > 0 && (pfd.revents & POLLIN) != 0;
}

bool HasPendingConnection(Socket& listener) {
  return WaitReadable(listener, 0);
}

Socket TryAcceptNow(Socket& listener) {
  if (!listener.valid() || !HasPendingConnection(listener)) return Socket();
  // The listener goes PERMANENTLY nonblocking on first use: several
  // channel drivers call this concurrently on ONE shared listener, and a
  // save/set/restore guard would race — one driver restoring blocking
  // mode while another sits inside accept(2) on a queue a third just
  // drained re-creates exactly the block-on-empty-queue hazard this
  // function exists to avoid.  The only other accept path (hvd::Accept)
  // already runs its accept nonblocking under poll, so the sticky flag
  // is harmless to it.
  int fl = ::fcntl(listener.fd(), F_GETFL, 0);
  if (fl >= 0 && (fl & O_NONBLOCK) == 0) {
    ::fcntl(listener.fd(), F_SETFL, fl | O_NONBLOCK);
  }
  int fd = ::accept(listener.fd(), nullptr, nullptr);
  if (fd < 0) return Socket();
  SetNoDelay(fd);
  return Socket(fd);
}

Socket ConnectStart(const std::string& host, int port, bool* in_progress,
                    std::string* err) {
  *in_progress = false;
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    *err = std::string("socket: ") + strerror(errno);
    return Socket();
  }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (!ResolveIPv4(host, &addr.sin_addr, err)) {
    ::close(fd);
    return Socket();
  }
  int fl = ::fcntl(fd, F_GETFL, 0);
  if (fl >= 0) ::fcntl(fd, F_SETFL, fl | O_NONBLOCK);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
    // Completed immediately (the loopback common case): hand back a
    // blocking socket like ConnectRetry would.
    SetNoDelay(fd);
    if (fl >= 0) ::fcntl(fd, F_SETFL, fl & ~O_NONBLOCK);
    return Socket(fd);
  }
  if (errno == EINPROGRESS) {
    *in_progress = true;
    return Socket(fd);  // caller polls POLLOUT, then ConnectFinish
  }
  *err = std::string("connect: ") + strerror(errno);
  ::close(fd);
  return Socket();
}

bool ConnectFinish(Socket& s, std::string* err) {
  int soerr = 0;
  socklen_t len = sizeof(soerr);
  if (::getsockopt(s.fd(), SOL_SOCKET, SO_ERROR, &soerr, &len) != 0) {
    soerr = errno;
  }
  if (soerr != 0) {
    *err = std::string("connect: ") + strerror(soerr);
    return false;
  }
  SetNoDelay(s.fd());
  int fl = ::fcntl(s.fd(), F_GETFL, 0);
  if (fl >= 0) ::fcntl(s.fd(), F_SETFL, fl & ~O_NONBLOCK);
  return true;
}

void ArmSocketDeadlines(Socket& s, int deadline_sec) {
  if (!s.valid()) return;
  int one = 1;
  ::setsockopt(s.fd(), SOL_SOCKET, SO_KEEPALIVE, &one, sizeof(one));
  // Probe timing: never SLOWER than the legacy ~30 s detection
  // (idle 10 + 4 x intvl 5), and tightened toward deadline_sec when a
  // smaller bound is in force (fault-capped socket timeouts).
  int idle = 10, intvl = 5, cnt = 4;
  if (deadline_sec > 0) {
    idle = std::max(1, std::min(10, deadline_sec / 3));
    intvl = std::max(1, std::min(5, deadline_sec / 6));
  }
  ::setsockopt(s.fd(), IPPROTO_TCP, TCP_KEEPIDLE, &idle, sizeof(idle));
  ::setsockopt(s.fd(), IPPROTO_TCP, TCP_KEEPINTVL, &intvl, sizeof(intvl));
  ::setsockopt(s.fd(), IPPROTO_TCP, TCP_KEEPCNT, &cnt, sizeof(cnt));
#ifdef TCP_USER_TIMEOUT
  if (deadline_sec > 0) {
    // Unacked transmit data older than this errors the socket (ETIMEDOUT)
    // — converting a "my sends vanish into retransmission limbo" stall
    // into a classifiable error the link-heal layer can act on.  Ignored
    // gracefully by kernels that lack the option (e.g. some sandboxes).
    unsigned to_ms = static_cast<unsigned>(deadline_sec) * 1000u;
    ::setsockopt(s.fd(), IPPROTO_TCP, TCP_USER_TIMEOUT, &to_ms,
                 sizeof(to_ms));
  }
#endif
}

Socket ConnectRetry(const std::string& host, int port, int deadline_ms,
                    std::string* error) {
  auto deadline = std::chrono::steady_clock::now() +
                  std::chrono::milliseconds(deadline_ms);
  std::string last_err;
  while (std::chrono::steady_clock::now() < deadline) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) {
      last_err = std::string("socket: ") + strerror(errno);
      break;
    }
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (!ResolveIPv4(host, &addr.sin_addr, error)) {
      ::close(fd);
      return Socket();
    }
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
      SetNoDelay(fd);
      return Socket(fd);
    }
    last_err = std::string("connect: ") + strerror(errno);
    ::close(fd);
    std::this_thread::sleep_for(std::chrono::milliseconds(20));
  }
  *error = "timed out connecting to " + host + ":" + std::to_string(port) +
           " (" + last_err + ")";
  return Socket();
}

bool SendRecvAll(Socket& snd, const void* send_buf, size_t sn,
                 Socket& rcv, void* recv_buf, size_t rn,
                 int timeout_ms, std::string* err) {
  return SendRecvChunked(snd, send_buf, sn, rcv, recv_buf, rn, /*chunk=*/0,
                         /*on_chunk=*/nullptr, timeout_ms, err);
}

bool SendRecvChunked(Socket& snd, const void* send_buf, size_t sn,
                     Socket& rcv, void* recv_buf, size_t rn, size_t chunk,
                     const std::function<void(size_t, size_t)>& on_chunk,
                     int timeout_ms, std::string* err, int64_t* wire_ns) {
  const char* sp = static_cast<const char*>(send_buf);
  char* rp = static_cast<char*>(recv_buf);
  const size_t rtotal = rn;
  // Receive bytes already handed to on_chunk; the poll loop fires the
  // callback whenever a whole chunk (or the final partial one) is in.
  size_t delivered = 0;
  if (chunk == 0) chunk = rtotal;  // single callback at the end
  auto t0 = std::chrono::steady_clock::now();
  auto deliver_ready = [&] {
    if (!on_chunk) return;
    size_t done = rtotal - rn;
    while (delivered < done &&
           (done - delivered >= chunk || rn == 0)) {
      size_t len = std::min(chunk, done - delivered);
      if (wire_ns != nullptr) {
        auto now = std::chrono::steady_clock::now();
        *wire_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
                        now - t0)
                        .count();
        on_chunk(delivered, len);
        t0 = std::chrono::steady_clock::now();
      } else {
        on_chunk(delivered, len);
      }
      delivered += len;
    }
  };
  NonblockGuard g1(snd.fd());
  NonblockGuard g2(rcv.fd());
  while (sn > 0 || rn > 0) {
    pollfd fds[2];
    int nfds = 0;
    int si = -1, ri = -1;
    if (sn > 0) {
      fds[nfds] = {snd.fd(), POLLOUT, 0};
      si = nfds++;
    }
    if (rn > 0) {
      fds[nfds] = {rcv.fd(), POLLIN, 0};
      ri = nfds++;
    }
    int rc = ::poll(fds, nfds, timeout_ms > 0 ? timeout_ms : -1);
    if (rc < 0) {
      if (errno == EINTR) continue;
      *err = std::string("poll: ") + strerror(errno);
      return false;
    }
    if (rc == 0) {
      // With both directions pending either neighbor may be the one that
      // stalled; "link" tells TransportError to name both candidates.
      const char* dir = (sn > 0 && rn > 0) ? "link: "
                        : sn > 0          ? "send to peer: "
                                          : "recv from peer: ";
      *err = dir + std::string("no progress for ") +
             std::to_string(timeout_ms / 1000) + "s (peer hung?)";
      return false;
    }
    if (si >= 0 && (fds[si].revents & (POLLOUT | POLLERR | POLLHUP)) != 0) {
      ssize_t k = ::send(snd.fd(), sp, sn, MSG_NOSIGNAL);
      if (k > 0) {
        sp += k;
        sn -= static_cast<size_t>(k);
      } else if (k < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
                 errno != EINTR) {
        *err = std::string("send to peer: ") + strerror(errno);
        return false;
      }
    }
    if (ri >= 0 && (fds[ri].revents & (POLLIN | POLLERR | POLLHUP)) != 0) {
      ssize_t k = ::recv(rcv.fd(), rp, rn, 0);
      if (k > 0) {
        rp += k;
        rn -= static_cast<size_t>(k);
        deliver_ready();
      } else if (k == 0) {
        *err = "recv from peer: connection closed (peer process exited?)";
        return false;
      } else if (errno != EAGAIN && errno != EWOULDBLOCK && errno != EINTR) {
        *err = std::string("recv from peer: ") + strerror(errno);
        return false;
      }
    }
  }
  if (wire_ns != nullptr) {
    auto now = std::chrono::steady_clock::now();
    *wire_ns +=
        std::chrono::duration_cast<std::chrono::nanoseconds>(now - t0).count();
  }
  return true;
}

}  // namespace hvd
