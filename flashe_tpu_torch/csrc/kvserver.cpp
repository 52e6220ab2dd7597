// Networked storage node (the port's copy of native/kvserver.cpp): the
// persistent KV store (kvstore.cpp) served over TCP — the analogue of
// eggroll's *remote* storage-service (the C++ LMDB node that FATE DTables
// talk to across processes/machines; SURVEY.md section 2.3).
// flashe_tpu_torch/data/remote_kv.py is the client (and carries a
// pure-python server speaking the same protocol for compiler-less
// environments).  Two divergences from native/kvserver.cpp: the egg it
// spawns is the port's (`-m flashe_tpu_torch.data.egg`), and a pooled EXEC
// is retried only when its spec could not be written to the worker, so a
// job that may have started (and written shuffle output) never runs twice.
//
// Wire protocol (little-endian):
//   request:  u8 op | u32 nslen | u32 namelen | u32 part | u32 klen |
//             u32 vlen | ns | name | key | value
//   response: u8 status | u64 len | payload
//
// Ops: 0 OPEN (part field = requested nparts; payload u32 = pinned
//      nparts — an existing store's on-disk partition count wins),
//      1 PUT, 2 GET (status 1 = missing), 3 DEL (status 1 = missing),
//      4 COUNT (payload u64), 5 ITER (payload stream of
//      u32 klen|u32 vlen|key|val records, terminated by klen=0xFFFFFFFF),
//      6 FLUSH, 7 SHUTDOWN,
//      8 EXEC (value = pickled job spec; the server spawns an egg
//        processor — `$FLASHE_PYTHON -m flashe_tpu_torch.data.egg <this
//        node's addr>` — pipes the spec to its stdin and relays the
//        pickled result from its stdout; payload = result pickle).
//        This is eggroll's roll/egg compute plane: the processor runs
//        next to the data, reading source partitions over loopback and
//        shuffling map output straight to the owning nodes, so records
//        never stream to the submitting client.
//
// Partition counts are pinned in a META file at store creation, the same
// "nparts=N" format the in-process store uses (data/kvstore.py), so a
// directory can be served locally or remotely interchangeably.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <signal.h>
#include <sys/socket.h>
#include <sys/wait.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <thread>
#include <vector>

#include "kvstore.cpp"  // storage core + C ABI (single-TU build)

namespace {

struct OpenStore {
  void* h = nullptr;
  int nparts = 0;
  std::mutex mu;
};

std::mutex g_mu;
std::map<std::string, OpenStore*> g_stores;
std::string g_root;
int g_port = 0;  // bound port; egg processors connect back over loopback
volatile bool g_stop = false;

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t r = send(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool send_resp(int fd, uint8_t status, const void* payload, uint64_t len) {
  char hdr[9];
  hdr[0] = (char)status;
  std::memcpy(hdr + 1, &len, 8);
  if (!write_full(fd, hdr, 9)) return false;
  if (len && !write_full(fd, payload, len)) return false;
  return true;
}

int pinned_nparts(const std::string& dir, int requested) {
  std::string meta = dir + "/META";
  if (FILE* f = std::fopen(meta.c_str(), "r")) {
    int n = requested;
    if (std::fscanf(f, "nparts=%d", &n) != 1) n = requested;
    std::fclose(f);
    return n;
  }
  ::mkdir(dir.c_str(), 0777);
  std::string tmp = meta + ".tmp" + std::to_string(getpid());
  if (FILE* f = std::fopen(tmp.c_str(), "w")) {
    std::fprintf(f, "nparts=%d\n", requested);
    std::fclose(f);
    std::rename(tmp.c_str(), meta.c_str());
  }
  return requested;
}

OpenStore* get_store(const std::string& ns, const std::string& name,
                     int requested_nparts) {
  std::lock_guard<std::mutex> lock(g_mu);
  std::string key = ns + "/" + name;
  auto it = g_stores.find(key);
  if (it != g_stores.end()) return it->second;
  std::string nsdir = g_root + "/" + ns;
  ::mkdir(nsdir.c_str(), 0777);
  std::string dir = nsdir + "/" + name;
  int nparts = pinned_nparts(dir, requested_nparts > 0 ? requested_nparts
                                                       : 1);
  void* h = kv_open(dir.c_str(), nparts);
  if (!h) return nullptr;
  auto* st = new OpenStore();
  st->h = h;
  st->nparts = nparts;
  g_stores[key] = st;
  return st;
}

bool fd_write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t r = write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

bool fd_read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= (size_t)r;
  }
  return true;
}

// ---- resident egg pool --------------------------------------------------
// eggroll keeps its egg processors alive in pools; forking a fresh
// interpreter per EXEC costs ~0.5 s of python imports before any record
// is touched.  FLASHE_EGG_POOL sets the pool size (default 2; 0 restores
// fork-per-job).  Each worker runs `flashe_tpu_torch.data.egg --loop` (spec
// and result length-prefixed over its pipes) and is serialized by its own
// mutex; a dead worker is respawned.  A job is retried once, on a fresh
// worker, only when its spec could not be written: a worker that took the
// spec may have started the job, and a replay could leave the output
// table a mix of two runs.

struct EggWorker {
  pid_t pid = -1;
  int in_fd = -1;   // spec out
  int out_fd = -1;  // result in
  std::mutex mu;
};

std::mutex g_egg_mu;
std::vector<EggWorker>* g_egg_pool = nullptr;
unsigned g_egg_rr = 0;

int egg_pool_size() {
  const char* e = getenv("FLASHE_EGG_POOL");
  return (e && *e) ? std::atoi(e) : 2;
}

void egg_kill(EggWorker& w) {
  if (w.in_fd >= 0) close(w.in_fd);
  if (w.out_fd >= 0) close(w.out_fd);
  if (w.pid > 0) {
    kill(w.pid, SIGKILL);  // exact child PID only
    waitpid(w.pid, nullptr, 0);
  }
  w.pid = -1;
  w.in_fd = w.out_fd = -1;
}

bool egg_spawn(EggWorker& w) {
  int in_pipe[2], out_pipe[2];
  if (pipe(in_pipe) != 0) return false;
  if (pipe(out_pipe) != 0) {
    close(in_pipe[0]);
    close(in_pipe[1]);
    return false;
  }
  pid_t pid = fork();
  if (pid < 0) {
    close(in_pipe[0]);
    close(in_pipe[1]);
    close(out_pipe[0]);
    close(out_pipe[1]);
    return false;
  }
  if (pid == 0) {  // resident egg child
    dup2(in_pipe[0], 0);
    dup2(out_pipe[1], 1);
    close(in_pipe[0]);
    close(in_pipe[1]);
    close(out_pipe[0]);
    close(out_pipe[1]);
    const char* py = getenv("FLASHE_PYTHON");
    if (!py || !*py) py = "python3";
    char addr[64];
    std::snprintf(addr, sizeof addr, "127.0.0.1:%d", g_port);
    execlp(py, py, "-m", "flashe_tpu_torch.data.egg", "--loop", addr,
           (char*)nullptr);
    _exit(127);
  }
  close(in_pipe[0]);
  close(out_pipe[1]);
  w.pid = pid;
  w.in_fd = in_pipe[1];
  w.out_fd = out_pipe[0];
  return true;
}

// One job on worker w.  kEggNotSent: the spec could not be written (the
// worker was dead before it could take it), so the job never started;
// kEggFailed: the worker died after it took the spec.
enum EggOutcome { kEggOk, kEggNotSent, kEggFailed };

EggOutcome egg_job(EggWorker& w, const std::string& spec,
                   std::string& result) {
  if (w.pid > 0 && waitpid(w.pid, nullptr, WNOHANG) == w.pid) {
    // died between jobs: reaped above, just drop the stale fds
    if (w.in_fd >= 0) close(w.in_fd);
    if (w.out_fd >= 0) close(w.out_fd);
    w.pid = -1;
    w.in_fd = w.out_fd = -1;
  }
  if (w.pid <= 0 && !egg_spawn(w)) return kEggNotSent;
  uint64_t n = spec.size();
  if (!(fd_write_full(w.in_fd, &n, 8) &&
        (n == 0 || fd_write_full(w.in_fd, spec.data(), n)))) {
    egg_kill(w);
    return kEggNotSent;
  }
  uint64_t rn = 0;
  bool ok = false;
  if (fd_read_full(w.out_fd, &rn, 8)) {
    result.resize(rn);
    ok = rn == 0 || fd_read_full(w.out_fd, &result[0], rn);
  }
  if (!ok) {
    egg_kill(w);
    return kEggFailed;
  }
  return kEggOk;
}

// EXEC: run the job in a resident egg processor near the data (or, with
// FLASHE_EGG_POOL=0, a freshly forked one).  No store mutex may be
// held here — the egg re-enters this server over loopback for its
// partition reads and shuffle writes.
void handle_exec_pooled(int fd, const std::string& spec, int pool) {
  {
    std::lock_guard<std::mutex> g(g_egg_mu);
    if (!g_egg_pool) g_egg_pool = new std::vector<EggWorker>(pool);
  }
  EggWorker* w = nullptr;
  std::unique_lock<std::mutex> held;
  for (auto& cand : *g_egg_pool) {
    std::unique_lock<std::mutex> l(cand.mu, std::try_to_lock);
    if (l.owns_lock()) {
      w = &cand;
      held = std::move(l);
      break;
    }
  }
  if (!w) {
    unsigned i;
    {
      std::lock_guard<std::mutex> g(g_egg_mu);
      i = g_egg_rr++ % g_egg_pool->size();
    }
    w = &(*g_egg_pool)[i];
    held = std::unique_lock<std::mutex>(w->mu);
  }
  std::string result;
  EggOutcome got = egg_job(*w, spec, result);
  // respawn + retry once, only for a spec that no worker took
  if (got == kEggNotSent) got = egg_job(*w, spec, result);
  if (got != kEggOk) {
    const char* msg = "egg processor failed (is FLASHE_PYTHON set and "
                      "flashe_tpu_torch on PYTHONPATH?)";
    send_resp(fd, 2, msg, std::strlen(msg));
    return;
  }
  send_resp(fd, 0, result.data(), result.size());
}

void handle_exec(int fd, const std::string& spec) {
  int pool = egg_pool_size();
  if (pool > 0) {
    handle_exec_pooled(fd, spec, pool);
    return;
  }
  int in_pipe[2], out_pipe[2];
  if (pipe(in_pipe) != 0) {
    send_resp(fd, 2, "pipe failed", 11);
    return;
  }
  if (pipe(out_pipe) != 0) {
    close(in_pipe[0]);
    close(in_pipe[1]);
    send_resp(fd, 2, "pipe failed", 11);
    return;
  }
  pid_t pid = fork();
  if (pid < 0) {
    close(in_pipe[0]);
    close(in_pipe[1]);
    close(out_pipe[0]);
    close(out_pipe[1]);
    send_resp(fd, 2, "fork failed", 11);
    return;
  }
  if (pid == 0) {  // egg child: spec on stdin, result pickle on stdout
    dup2(in_pipe[0], 0);
    dup2(out_pipe[1], 1);
    close(in_pipe[0]);
    close(in_pipe[1]);
    close(out_pipe[0]);
    close(out_pipe[1]);
    const char* py = getenv("FLASHE_PYTHON");
    if (!py || !*py) py = "python3";
    char addr[64];
    std::snprintf(addr, sizeof addr, "127.0.0.1:%d", g_port);
    execlp(py, py, "-m", "flashe_tpu_torch.data.egg", addr, (char*)nullptr);
    _exit(127);
  }
  close(in_pipe[0]);
  close(out_pipe[1]);
  uint64_t n = spec.size();
  bool ok = fd_write_full(in_pipe[1], &n, 8) &&
            (n == 0 || fd_write_full(in_pipe[1], spec.data(), n));
  close(in_pipe[1]);
  uint64_t rn = 0;
  std::string result;
  if (ok && fd_read_full(out_pipe[0], &rn, 8)) {
    result.resize(rn);
    ok = rn == 0 || fd_read_full(out_pipe[0], &result[0], rn);
  } else {
    ok = false;
  }
  close(out_pipe[0]);
  int status = 0;
  waitpid(pid, &status, 0);
  if (!ok || !WIFEXITED(status) || WEXITSTATUS(status) != 0) {
    const char* msg = "egg processor failed (is FLASHE_PYTHON set and "
                      "flashe_tpu_torch on PYTHONPATH?)";
    send_resp(fd, 2, msg, std::strlen(msg));
    return;
  }
  send_resp(fd, 0, result.data(), result.size());
}

void serve_conn(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  std::string ns, name, key, val;
  for (;;) {
    char hdr[21];
    if (!read_full(fd, hdr, 21)) break;
    uint8_t op = (uint8_t)hdr[0];
    uint32_t lens[5];
    std::memcpy(lens, hdr + 1, 20);
    uint32_t nslen = lens[0], namelen = lens[1], part = lens[2],
             klen = lens[3], vlen = lens[4];
    ns.resize(nslen);
    name.resize(namelen);
    key.resize(klen);
    val.resize(vlen);
    if (nslen && !read_full(fd, &ns[0], nslen)) break;
    if (namelen && !read_full(fd, &name[0], namelen)) break;
    if (klen && !read_full(fd, &key[0], klen)) break;
    if (vlen && !read_full(fd, &val[0], vlen)) break;
    if (op == 7) {  // SHUTDOWN: flush everything, ack, exit
      {
        // lock ordering g_mu then st->mu matches get_store/serve_conn;
        // taking each store's mu quiesces in-flight ops on other
        // connection threads so no put can race the final flush and
        // leave a torn (unacked-loss) tail.
        std::lock_guard<std::mutex> lock(g_mu);
        for (auto& kv : g_stores) {
          std::lock_guard<std::mutex> st_lock(kv.second->mu);
          kv_flush(kv.second->h);
        }
      }
      send_resp(fd, 0, nullptr, 0);
      close(fd);
      std::_Exit(0);
    }
    if (op == 8) {  // EXEC
      handle_exec(fd, val);
      continue;
    }
    OpenStore* st = get_store(ns, name, (int)part);
    if (!st) {
      if (!send_resp(fd, 2, nullptr, 0)) break;
      continue;
    }
    std::lock_guard<std::mutex> lock(st->mu);
    bool ok = true;
    switch (op) {
      case 0: {  // OPEN -> pinned nparts
        uint32_t n = (uint32_t)st->nparts;
        ok = send_resp(fd, 0, &n, 4);
        break;
      }
      case 1:  // PUT
        ok = send_resp(fd,
                       kv_put(st->h, (int)part, key.data(), klen,
                              val.data(), vlen) == 0 ? 0 : 2,
                       nullptr, 0);
        break;
      case 2: {  // GET
        int64_t n = kv_get_len(st->h, (int)part, key.data(), klen);
        if (n < 0) {
          ok = send_resp(fd, 1, nullptr, 0);
        } else {
          std::string out((size_t)n, '\0');
          if (kv_get(st->h, (int)part, key.data(), klen,
                     n ? &out[0] : nullptr) != 0) {
            ok = send_resp(fd, 2, nullptr, 0);
          } else {
            ok = send_resp(fd, 0, out.data(), (uint64_t)n);
          }
        }
        break;
      }
      case 3:  // DEL
        ok = send_resp(
            fd, kv_del(st->h, (int)part, key.data(), klen) == 0 ? 0 : 1,
            nullptr, 0);
        break;
      case 4: {  // COUNT
        uint64_t n = (uint64_t)kv_count(st->h, (int)part);
        ok = send_resp(fd, 0, &n, 8);
        break;
      }
      case 5: {  // ITER: stream records then a terminator
        std::string out;
        void* iter = kv_iter_open(st->h, (int)part);
        uint32_t kl, vl;
        while (kv_iter_next_lens(iter, &kl, &vl) == 0) {
          size_t base = out.size();
          out.resize(base + 8 + kl + vl);
          std::memcpy(&out[base], &kl, 4);
          std::memcpy(&out[base + 4], &vl, 4);
          kv_iter_fill(iter, &out[base + 8], &out[base + 8 + kl]);
        }
        kv_iter_close(iter);
        uint32_t term = kTombstone;
        size_t base = out.size();
        out.resize(base + 4);
        std::memcpy(&out[base], &term, 4);
        ok = send_resp(fd, 0, out.data(), out.size());
        break;
      }
      case 6:  // FLUSH
        kv_flush(st->h);
        ok = send_resp(fd, 0, nullptr, 0);
        break;
      default:
        ok = send_resp(fd, 3, nullptr, 0);
    }
    if (!ok) break;
  }
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: kvserver <root_dir> <port>\n");
    return 2;
  }
  g_root = argv[1];
  ::mkdir(g_root.c_str(), 0777);
  // a client or egg pipe dying mid-write must surface as an error
  // return, not a process-killing SIGPIPE
  signal(SIGPIPE, SIG_IGN);
  int port = std::atoi(argv[2]);
  int srv = socket(AF_INET, SOCK_STREAM, 0);
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons((uint16_t)port);
  if (bind(srv, (sockaddr*)&addr, sizeof(addr)) != 0) {
    std::perror("bind");
    return 1;
  }
  socklen_t alen = sizeof(addr);
  getsockname(srv, (sockaddr*)&addr, &alen);
  g_port = (int)ntohs(addr.sin_port);
  listen(srv, 64);
  // the chosen port on stdout so a parent process can connect (port 0 =
  // ephemeral), matching fedbroker's handshake convention
  std::printf("KVSERVER PORT %d\n", (int)ntohs(addr.sin_port));
  std::fflush(stdout);
  while (!g_stop) {
    int fd = accept(srv, nullptr, nullptr);
    if (fd < 0) break;
    std::thread(serve_conn, fd).detach();
  }
  close(srv);
  // drop store handles (flush happens on close)
  for (auto& kv : g_stores) kv_close(kv.second->h);
  return 0;
}
