// Native federation exchange ("the broker"): the port's copy of
// native/fedbroker.cpp.
//
// The replacement for the reference's WAN-facing Java services
// (arch/networking/proxy: gRPC DataTransferService push/pull routed by
// route_table.json; arch/driver/federation: TransferSubmitService with
// LMDB staging).  All inter-party bytes — control messages and model
// ciphertexts — traverse this single hop, so it is native code, like the
// reference's, and does zero deserialization on the data path: frames
// carry a fixed binary envelope (op, dst role, dst party id) and the
// broker routes the raw bytes to the registered destination connection,
// buffering frames whose destination has not registered yet (the
// analogue of the reference's pull-based recv with status polling).
//
// Wire protocol (all integers big-endian):
//   frame   := u64 length | body
//   body    := u8 op | rest
//   op 0 (REGISTER): u8 role_len | role bytes | i32 party_id
//   op 1 (DATA):     u8 role_len | dst role bytes | i32 dst party_id |
//                    opaque payload (pickled metadata + fragment bytes —
//                    never inspected here)
// A frame longer than kMaxFrame ends its sender's connection.
//
// Usage: fedbroker [port] [bind_ip] [--lifeline]
// (port 0 = ephemeral; default bind 127.0.0.1; prints "PORT <n>\n" on
// stdout once listening and nothing after, then serves until killed.
// With --lifeline it also exits when its standard input reaches end of
// file: the process that spawns it holds the pipe's other end, so the
// broker ends with that process however it ends.)  The one divergence
// from native/fedbroker.cpp is --lifeline.
//
// Build: g++ -O3 -pthread -o fedbroker fedbroker.cpp
// (flashe_tpu_torch/native.py builds it on demand into
// build/flashe_tpu_torch/; flashe_tpu_torch/fed/tcp.py has a pure-Python
// fallback broker speaking the same protocol.)

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kMaxFrame = 1ull << 26;  // 64MB; fragments are ~4MB

struct Conn {
  int fd;
  std::mutex write_mu;
  explicit Conn(int f) : fd(f) {}
};

std::mutex g_mu;
// key = role + '\x00' + decimal party id (role bytes never contain NUL:
// roles are "guest"/"host"/"arbiter" identifiers from the Python side)
std::map<std::string, std::shared_ptr<Conn>> g_conns;
std::map<std::string, std::vector<std::string>> g_pending;

bool read_exact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

uint64_t be64(const unsigned char* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
  return v;
}

int32_t be32(const unsigned char* p) {
  uint32_t v = 0;
  for (int i = 0; i < 4; i++) v = (v << 8) | p[i];
  return static_cast<int32_t>(v);
}

// Reads one length-prefixed frame body into out. False on EOF/overflow.
bool read_frame(int fd, std::string* out) {
  unsigned char hdr[8];
  if (!read_exact(fd, hdr, 8)) return false;
  uint64_t len = be64(hdr);
  if (len == 0 || len > kMaxFrame) return false;
  out->resize(len);
  return read_exact(fd, &(*out)[0], len);
}

// Writes u64 length + body under the connection's write mutex (many
// sources can route to one destination concurrently).
bool write_frame(Conn& c, const std::string& body) {
  unsigned char hdr[8];
  uint64_t len = body.size();
  for (int i = 7; i >= 0; i--) {
    hdr[i] = static_cast<unsigned char>(len & 0xff);
    len >>= 8;
  }
  std::lock_guard<std::mutex> lk(c.write_mu);
  struct Part { const void* base; size_t n; } parts[2] = {
      {hdr, 8}, {body.data(), body.size()}};
  for (auto& part : parts) {
    const char* p = static_cast<const char*>(part.base);
    size_t n = part.n;
    while (n > 0) {
      ssize_t w = send(c.fd, p, n, MSG_NOSIGNAL);
      if (w <= 0) return false;
      p += w;
      n -= static_cast<size_t>(w);
    }
  }
  return true;
}

// Parses the envelope's (role, party) key starting at body[1].
// Returns empty string on malformed envelope.
std::string parse_key(const std::string& body) {
  if (body.size() < 2) return "";
  size_t role_len = static_cast<unsigned char>(body[1]);
  if (body.size() < 2 + role_len + 4) return "";
  std::string role = body.substr(2, role_len);
  int32_t party = be32(
      reinterpret_cast<const unsigned char*>(body.data()) + 2 + role_len);
  return role + '\x00' + std::to_string(party);
}

void serve(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));

  std::string frame;
  if (!read_frame(fd, &frame) || frame.empty() || frame[0] != 0) {
    close(fd);
    return;
  }
  std::string me = parse_key(frame);
  if (me.empty()) {
    close(fd);
    return;
  }
  auto conn = std::make_shared<Conn>(fd);
  std::vector<std::string> backlog;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    g_conns[me] = conn;
    auto it = g_pending.find(me);
    if (it != g_pending.end()) {
      backlog.swap(it->second);
      g_pending.erase(it);
    }
  }
  for (auto& f : backlog) write_frame(*conn, f);

  while (read_frame(fd, &frame)) {
    if (frame.empty() || frame[0] != 1) continue;  // only DATA is routable
    std::string dst = parse_key(frame);
    if (dst.empty()) continue;
    std::shared_ptr<Conn> target;
    {
      std::lock_guard<std::mutex> lk(g_mu);
      auto it = g_conns.find(dst);
      if (it == g_conns.end()) {
        g_pending[dst].emplace_back(std::move(frame));
        frame.clear();
        continue;
      }
      target = it->second;
    }
    if (!write_frame(*target, frame)) {
      // Destination died mid-write: requeue for a reconnect.
      std::lock_guard<std::mutex> lk(g_mu);
      if (g_conns[dst] == target) g_conns.erase(dst);
      g_pending[dst].emplace_back(std::move(frame));
      frame.clear();
    }
  }
  {
    std::lock_guard<std::mutex> lk(g_mu);
    auto it = g_conns.find(me);
    if (it != g_conns.end() && it->second == conn) g_conns.erase(it);
  }
  close(fd);
}

// Exits the process once standard input reaches end of file (or fails).
void lifeline() {
  char buf[256];
  while (true) {
    ssize_t r = read(0, buf, sizeof(buf));
    if (r == 0 || (r < 0 && errno != EINTR)) _exit(0);
  }
}

}  // namespace

int main(int argc, char** argv) {
  signal(SIGPIPE, SIG_IGN);
  bool with_lifeline = argc > 3 && strcmp(argv[3], "--lifeline") == 0;
  if (argc > 3 && !with_lifeline)
    return fprintf(stderr, "unknown option %s\n", argv[3]), 1;
  int port = argc > 1 ? atoi(argv[1]) : 0;

  int srv = socket(AF_INET, SOCK_STREAM, 0);
  if (srv < 0) return perror("socket"), 1;
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (argc > 2 && inet_pton(AF_INET, argv[2], &addr.sin_addr) != 1)
    return fprintf(stderr, "bad bind address %s\n", argv[2]), 1;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
    return perror("bind"), 1;
  if (listen(srv, 128) < 0) return perror("listen"), 1;

  socklen_t alen = sizeof(addr);
  getsockname(srv, reinterpret_cast<sockaddr*>(&addr), &alen);
  printf("PORT %d\n", ntohs(addr.sin_port));
  fflush(stdout);
  if (with_lifeline) std::thread(lifeline).detach();

  while (true) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) {
      if (errno == EINTR) continue;
      break;
    }
    std::thread(serve, fd).detach();
  }
  return 0;
}
