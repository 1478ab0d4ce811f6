// teio: the port's native IO runtime (LMDB engine and batch loader).
//
// The reference's data layer is Python LMDB + PIL JPEG decode behind a
// torch DataLoader (utils/dataset.py:9-45).  This library replaces it
// with a dependency-free native path:
//   * a read-only LMDB engine (mmap + B-tree walk over the published
//     on-disk format; no liblmdb needed),
//   * JPEG decode by the port's own codec (jpeg.cpp, no libjpeg),
//   * a background-thread batch loader with a bounded ring of decoded
//     [batch, res, res, 3] uint8 buffers (host decode overlaps device
//     compute; the Python side only memcpys out of the queue).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 teio.cpp jpeg.cpp -o libteio.so
//        -lpthread
//
// C ABI only (consumed via ctypes; the JPEG entry points are jpeg.cpp's).

#include <cstddef>
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <random>
#include <thread>
#include <mutex>
#include <atomic>
#include <condition_variable>
#include <deque>
#include <algorithm>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

// jpeg.cpp: RGB8 decode into out (w*h*3); 0 ok, < 0 refused
extern "C" int teio_jpeg_decode(const uint8_t* buf, long len, uint8_t* out,
                                int w, int h);

// ---------------------------------------------------------------------------
// LMDB read-only engine
//
// On-disk layout (64-bit): 16-byte page header
//   u64 pgno | u16 pad | u16 flags | u16 lower | u16 upper
// (lower/upper form u32 "pages" for overflow pages).  Node pointer
// array of u16 offsets begins at byte 16.  Branch nodes hold a 48-bit
// child pgno in (lo, hi, flags); leaf nodes hold data size in (lo, hi)
// with F_BIGDATA indicating an 8-byte overflow pgno after the key.

namespace lmdb {

constexpr uint16_t P_BRANCH = 0x01, P_LEAF = 0x02, P_OVERFLOW = 0x04,
                   P_META = 0x08, P_LEAF2 = 0x20;
constexpr uint16_t F_BIGDATA = 0x01;
constexpr uint32_t MDB_MAGIC = 0xBEEFC0DE;

#pragma pack(push, 1)
struct PageHdr {
  uint64_t pgno;
  uint16_t pad;
  uint16_t flags;
  union {
    struct { uint16_t lower, upper; } b;
    uint32_t pages;
  };
};
struct Db {
  uint32_t pad;
  uint16_t flags;
  uint16_t depth;
  uint64_t branch_pages, leaf_pages, overflow_pages, entries, root;
};
struct Meta {
  uint32_t magic;
  uint32_t version;
  uint64_t address;
  uint64_t mapsize;
  Db dbs[2];
  uint64_t last_pg;
  uint64_t txnid;
};
struct Node {
  uint16_t lo, hi, flags, ksize;
  // key bytes follow, then data (or u64 overflow pgno if F_BIGDATA)
};
#pragma pack(pop)

struct Env {
  int fd = -1;
  const uint8_t* map = nullptr;
  size_t size = 0;
  size_t psize = 4096;
  Db main_db{};

  // bounds-checked: a truncated/corrupt file must fail the lookup, not
  // fault the mmap (the Python lmdb binding raises; so do we)
  const PageHdr* page(uint64_t pgno) const {
    if (pgno >= size / psize) return nullptr;
    return reinterpret_cast<const PageHdr*>(map + pgno * psize);
  }
};

static const Meta* meta_at(const uint8_t* base, size_t avail) {
  if (avail < sizeof(PageHdr) + sizeof(Meta)) return nullptr;
  const PageHdr* ph = reinterpret_cast<const PageHdr*>(base);
  if (!(ph->flags & P_META)) return nullptr;
  const Meta* m = reinterpret_cast<const Meta*>(base + sizeof(PageHdr));
  if (m->magic != MDB_MAGIC) return nullptr;
  return m;
}

Env* env_open(const char* path) {
  std::string p(path);
  struct stat st;
  // accept either a directory (containing data.mdb) or the file itself
  std::string file = p;
  if (stat(p.c_str(), &st) == 0 && S_ISDIR(st.st_mode))
    file = p + "/data.mdb";
  int fd = open(file.c_str(), O_RDONLY);
  if (fd < 0) return nullptr;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) { close(fd); return nullptr; }

  Env* env = new Env();
  env->fd = fd;
  env->map = static_cast<const uint8_t*>(map);
  env->size = st.st_size;

  // find page size by locating the second meta page
  const Meta* m0 = meta_at(env->map, env->size);
  const Meta* m1 = nullptr;
  size_t psize = 0;
  for (size_t cand : {4096ul, 8192ul, 16384ul, 32768ul, 65536ul}) {
    if (cand >= env->size) break;
    const Meta* m = meta_at(env->map + cand, env->size - cand);
    if (m) { m1 = m; psize = cand; break; }
  }
  if (!m0 || !m1) { delete env; return nullptr; }
  env->psize = psize;
  const Meta* m = (m0->txnid > m1->txnid) ? m0 : m1;
  env->main_db = m->dbs[1];
  return env;
}

void env_close(Env* env) {
  if (!env) return;
  if (env->map) munmap(const_cast<uint8_t*>(env->map), env->size);
  if (env->fd >= 0) close(env->fd);
  delete env;
}

// nullptr if the node offset or its key bytes fall outside the page
static const Node* node_at(const Env* env, const PageHdr* pg, size_t i) {
  const uint16_t* ptrs = reinterpret_cast<const uint16_t*>(
      reinterpret_cast<const uint8_t*>(pg) + sizeof(PageHdr));
  size_t off = ptrs[i];
  if (off < sizeof(PageHdr) || off + sizeof(Node) > env->psize)
    return nullptr;
  const Node* n = reinterpret_cast<const Node*>(
      reinterpret_cast<const uint8_t*>(pg) + off);
  if (off + sizeof(Node) + n->ksize > env->psize) return nullptr;
  return n;
}

static size_t num_keys(const Env* env, const PageHdr* pg) {
  if (pg->b.lower < sizeof(PageHdr)) return 0;
  size_t n = (pg->b.lower - sizeof(PageHdr)) >> 1;
  // the node-pointer array itself must fit in the page
  return std::min(n, (env->psize - sizeof(PageHdr)) / 2);
}

static int key_cmp(const uint8_t* a, size_t alen, const uint8_t* b,
                   size_t blen) {
  int c = memcmp(a, b, alen < blen ? alen : blen);
  if (c) return c;
  return (alen < blen) ? -1 : (alen > blen ? 1 : 0);
}

static uint64_t branch_child(const Node* n) {
  return uint64_t(n->lo) | (uint64_t(n->hi) << 16)
       | (uint64_t(n->flags) << 32);
}

static const uint8_t* node_key(const Node* n) {
  return reinterpret_cast<const uint8_t*>(n) + 8;
}

// returns 0 on success; -1 not found; -2/-3 malformed database
int get(const Env* env, const uint8_t* key, size_t klen,
        const uint8_t** val, size_t* vlen) {
  if (env->main_db.root == ~0ull) return -1;
  const PageHdr* pg = env->page(env->main_db.root);
  // descend branches; depth-capped so a cyclic pgno chain in a corrupt
  // file terminates instead of spinning
  for (int depth = 0; pg && (pg->flags & P_BRANCH); ++depth) {
    if (depth > 64) return -3;
    size_t n = num_keys(env, pg);
    if (n == 0) return -3;
    // find last child whose key <= search key (node 0 key is implicit-low)
    size_t lo = 1, hi = n;  // candidate range for first key > target
    while (lo < hi) {
      size_t mid = (lo + hi) / 2;
      const Node* nd = node_at(env, pg, mid);
      if (!nd) return -3;
      if (key_cmp(node_key(nd), nd->ksize, key, klen) <= 0) lo = mid + 1;
      else hi = mid;
    }
    const Node* child = node_at(env, pg, lo - 1);
    if (!child) return -3;
    pg = env->page(branch_child(child));
  }
  if (!pg || !(pg->flags & P_LEAF)) return -2;
  size_t n = num_keys(env, pg);
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    const Node* nd = node_at(env, pg, mid);
    if (!nd) return -3;
    int c = key_cmp(node_key(nd), nd->ksize, key, klen);
    if (c == 0) {
      size_t off = size_t(reinterpret_cast<const uint8_t*>(nd)
                          - reinterpret_cast<const uint8_t*>(pg));
      size_t dsize = uint64_t(nd->lo) | (uint64_t(nd->hi) << 16);
      if (nd->flags & F_BIGDATA) {
        if (off + sizeof(Node) + nd->ksize + 8 > env->psize) return -3;
        uint64_t opg;
        memcpy(&opg, node_key(nd) + nd->ksize, 8);
        const PageHdr* oph = env->page(opg);
        // overflow data is contiguous pages; the whole run must be mapped
        if (!oph ||
            dsize > env->size - (opg * env->psize + sizeof(PageHdr)))
          return -3;
        *val = reinterpret_cast<const uint8_t*>(oph) + sizeof(PageHdr);
        *vlen = dsize;
      } else {
        if (off + sizeof(Node) + nd->ksize + dsize > env->psize)
          return -3;
        *val = node_key(nd) + nd->ksize;
        *vlen = dsize;
      }
      return 0;
    }
    if (c < 0) lo = mid + 1; else hi = mid;
  }
  return -1;
}

}  // namespace lmdb

// ---------------------------------------------------------------------------
// batch loader

struct Loader {
  lmdb::Env* env = nullptr;
  int resolution = 256;
  int batch = 16;
  long n = 0;
  long host_index = 0, host_count = 1;
  bool shuffle = true;
  size_t frame_bytes = 0;

  int n_workers = 1;
  // workers with a non-empty sub-shard; queue admission round-robins
  // over these so no shard is ever starved (coverage is deterministic
  // even on a single host core)
  int active_workers = 1;
  long turn = 0;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::deque<std::vector<uint8_t>> queue;
  size_t max_queue = 4;
  std::atomic<bool> stop{false};
  uint64_t seed = 0;

  ~Loader() {
    stop = true;
    cv_full.notify_all();
    cv_empty.notify_all();
    for (auto& t : workers) if (t.joinable()) t.join();
    lmdb::env_close(env);
  }
};

static long lmdb_length(lmdb::Env* env) {
  const uint8_t* v;
  size_t vlen;
  const char* k = "length";
  if (lmdb::get(env, reinterpret_cast<const uint8_t*>(k), 6, &v, &vlen)
      == 0) {
    std::string s(reinterpret_cast<const char*>(v), vlen);
    return atol(s.c_str());
  }
  // fall back to entry count minus the metadata key
  return long(env->main_db.entries) - 1;
}

// Worker w of n_workers decodes its own sub-shard of the host's index
// shard (stride host_count * n_workers), so concurrent workers never
// duplicate samples within an epoch.  LMDB reads are lock-free: the
// engine is a stateless B-tree walk over a read-only mmap.  Decodes
// run fully in parallel; only queue ADMISSION is round-robin across
// workers, which makes batch interleaving (and therefore epoch
// coverage) deterministic instead of scheduler-dependent.
static void loader_worker(Loader* L, int w) {
  std::mt19937_64 rng(L->seed + L->host_index * 1000 + w);
  std::vector<long> order;
  for (long i = L->host_index + long(L->host_count) * w; i < L->n;
       i += L->host_count * L->n_workers)
    order.push_back(i);
  if (order.empty()) return;  // more workers than samples in the shard
  size_t pos = order.size();

  char key[64];
  while (!L->stop) {
    std::vector<uint8_t> frame(L->frame_bytes);
    long retry_idx = -1;  // corrupt-record random retry, see below
    for (int b = 0; b < L->batch; ++b) {
      // checked INSIDE the fill loop: if every record is corrupt the
      // retry path spins here forever and the destructor's join would
      // hang the process
      if (L->stop) return;
      long idx;
      if (retry_idx >= 0) {
        idx = retry_idx;
        retry_idx = -1;
      } else {
        if (pos >= order.size()) {
          if (L->shuffle) std::shuffle(order.begin(), order.end(), rng);
          pos = 0;
        }
        idx = order[pos++];
      }
      int klen = snprintf(key, sizeof key, "%d-%05ld",
                          L->resolution, idx);
      const uint8_t* val;
      size_t vlen;
      if (lmdb::get(L->env, reinterpret_cast<const uint8_t*>(key), klen,
                    &val, &vlen) != 0 ||
          teio_jpeg_decode(val, long(vlen),
                          frame.data() + size_t(b) * L->resolution
                              * L->resolution * 3,
                          L->resolution, L->resolution) != 0) {
        // corrupt record: mirror the reference's retry-random fallback
        // (utils/dataset.py:38-45); the retried index is actually used
        // on the next iteration instead of the next in-order sample
        retry_idx = long(rng() % uint64_t(L->n));
        --b;
        continue;
      }
    }
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_full.wait(lk, [&] {
      return L->stop || (L->queue.size() < L->max_queue &&
                         L->turn % L->active_workers == w); });
    if (L->stop) return;
    L->queue.push_back(std::move(frame));
    ++L->turn;
    L->cv_empty.notify_one();
    L->cv_full.notify_all();  // the admission turn moved on
  }
}

// ---------------------------------------------------------------------------
// C ABI

extern "C" {

void* teio_lmdb_open(const char* path) { return lmdb::env_open(path); }
void teio_lmdb_close(void* env) {
  lmdb::env_close(static_cast<lmdb::Env*>(env));
}
long teio_lmdb_entries(void* env) {
  return long(static_cast<lmdb::Env*>(env)->main_db.entries);
}
long teio_lmdb_length(void* env) {
  return lmdb_length(static_cast<lmdb::Env*>(env));
}
// copies value into out (if vcap big enough); returns value size or <0
long teio_lmdb_get(void* env, const uint8_t* key, long klen,
                   uint8_t* out, long vcap) {
  const uint8_t* val;
  size_t vlen;
  int rc = lmdb::get(static_cast<lmdb::Env*>(env), key, size_t(klen),
                     &val, &vlen);
  if (rc != 0) return rc;
  if (long(vlen) <= vcap) memcpy(out, val, vlen);
  return long(vlen);
}

void* teio_loader_create(const char* lmdb_path, int resolution, int batch,
                         int prefetch, uint64_t seed, int shuffle,
                         long host_index, long host_count, int n_workers) {
  lmdb::Env* env = lmdb::env_open(lmdb_path);
  if (!env) return nullptr;
  Loader* L = new Loader();
  L->env = env;
  L->resolution = resolution;
  L->batch = batch;
  L->max_queue = prefetch > 0 ? size_t(prefetch) : 2;
  L->seed = seed;
  L->shuffle = shuffle != 0;
  L->host_index = host_index;
  L->host_count = host_count;
  L->n_workers = n_workers > 0 ? n_workers : 1;
  L->n = lmdb_length(env);
  // a corrupt 'length' record (or corrupt meta entry count) must fail
  // creation, not size the per-worker index vectors: no well-formed
  // file can hold more records than half its bytes (each leaf node
  // costs >= a 2-byte pointer slot alone)
  if (L->n <= 0 || uint64_t(L->n) > env->size / 2) {
    delete L;
    return nullptr;
  }
  // ranks with a non-empty sub-shard form a prefix [0, k): worker w's
  // first index is host_index + host_count*w, so k = ceil((n - host_index)
  // / host_count) capped at n_workers.  Only these join the admission
  // rotation.
  long k = (L->n - L->host_index + L->host_count - 1) / L->host_count;
  L->active_workers = int(std::min<long>(L->n_workers, std::max<long>(k, 1)));
  L->frame_bytes = size_t(batch) * resolution * resolution * 3;
  for (int w = 0; w < L->n_workers; ++w)
    L->workers.emplace_back(loader_worker, L, w);
  return L;
}

// fills out[batch*res*res*3] uint8; returns 0 ok
int teio_loader_next(void* loader, uint8_t* out) {
  Loader* L = static_cast<Loader*>(loader);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_empty.wait(lk, [&] { return L->stop || !L->queue.empty(); });
  if (L->queue.empty()) return -1;
  std::vector<uint8_t> frame = std::move(L->queue.front());
  L->queue.pop_front();
  // notify_all: only the worker whose admission turn it is may proceed,
  // and notify_one could wake a different one (lost wakeup).
  L->cv_full.notify_all();
  lk.unlock();
  memcpy(out, frame.data(), frame.size());
  return 0;
}

void teio_loader_destroy(void* loader) {
  delete static_cast<Loader*>(loader);
}

}  // extern "C"
