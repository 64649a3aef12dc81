// Native runtime core: embedded KV store, async block device, bitmap
// allocator. C ABI for ctypes (ceph_tpu_torch/native/rt.py). The port's
// own copy of ceph_tpu/native/rt_native.cc.
//
// Roles (see SURVEY.md section 2.2):
//  - ctkv_*:    the src/kv KeyValueDB seam + RocksDB's job for the
//               store: an ordered map with atomic batches, WAL
//               durability and snapshot compaction (the memtable+WAL
//               half of an LSM; BlueStore's metadata path).
//  - ctblk_*:   the src/blk BlockDevice seam: pread/pwrite on a raw
//               file plus an IO thread pool for async writes
//               (KernelDevice's libaio role) with a drain/flush
//               barrier.
//  - ctalloc_*: the BlueStore block allocator seam
//               (fastbmap_allocator_impl role): first-fit contiguous
//               allocation over a word-scanned bitmap with a cursor
//               hint.
//
// Not copied from the reference: the reference's RocksDB/libaio are
// vendored third-party submodules; these are fresh minimal
// implementations of the same contracts.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <condition_variable>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>
#include <sys/stat.h>

// ---------------------------------------------------------------- crc32c
// Castagnoli, table-driven (same polynomial as ct_native.cc's oracle;
// duplicated here so the two .so files stay standalone).

static uint32_t crc_table[256];
static std::once_flag crc_once;

static void crc_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int j = 0; j < 8; j++)
      c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : (c >> 1);
    crc_table[i] = c;
  }
}

static uint32_t crc32c(uint32_t crc, const void* buf, size_t len) {
  std::call_once(crc_once, crc_init);
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  crc = ~crc;
  while (len--) crc = (crc >> 8) ^ crc_table[(crc ^ *p++) & 0xFF];
  return ~crc;
}

// ------------------------------------------------------------------- kv

namespace {

constexpr uint32_t KV_SNAP_MAGIC = 0x4B565453u;  // "STVK"
constexpr uint32_t KV_SNAP_VERSION = 1;

struct KvStore {
  std::map<std::string, std::string> data;
  std::string dir;
  int wal_fd = -1;
  uint64_t seq = 0;        // last applied batch sequence
  uint64_t wal_size = 0;
  bool do_fsync = false;
  std::mutex mu;
};

static void put_u32(std::string& s, uint32_t v) {
  char b[4];
  memcpy(b, &v, 4);
  s.append(b, 4);
}

static void put_u64(std::string& s, uint64_t v) {
  char b[8];
  memcpy(b, &v, 8);
  s.append(b, 8);
}

static bool get_u32(const uint8_t* p, size_t n, size_t& off, uint32_t* v) {
  if (off + 4 > n) return false;
  memcpy(v, p + off, 4);
  off += 4;
  return true;
}

static bool get_u64(const uint8_t* p, size_t n, size_t& off, uint64_t* v) {
  if (off + 8 > n) return false;
  memcpy(v, p + off, 8);
  off += 8;
  return true;
}

// Batch payload: u32 n_ops, then per op: u8 type (0 put, 1 del),
// u32 klen, key, [u32 vlen, value] for puts. Shared between the ctypes
// caller and WAL replay.
static bool apply_batch(KvStore* kv, const uint8_t* p, size_t n) {
  size_t off = 0;
  uint32_t nops;
  if (!get_u32(p, n, off, &nops)) return false;
  for (uint32_t i = 0; i < nops; i++) {
    if (off + 1 > n) return false;
    uint8_t type = p[off++];
    uint32_t klen;
    if (!get_u32(p, n, off, &klen) || off + klen > n) return false;
    std::string key(reinterpret_cast<const char*>(p + off), klen);
    off += klen;
    if (type == 0) {
      uint32_t vlen;
      if (!get_u32(p, n, off, &vlen) || off + vlen > n) return false;
      kv->data[std::move(key)].assign(
          reinterpret_cast<const char*>(p + off), vlen);
      off += vlen;
    } else if (type == 1) {
      kv->data.erase(key);
    } else {
      return false;
    }
  }
  return off == n;
}

static bool validate_batch(const uint8_t* p, size_t n) {
  size_t off = 0;
  uint32_t nops;
  if (!get_u32(p, n, off, &nops)) return false;
  for (uint32_t i = 0; i < nops; i++) {
    if (off + 1 > n) return false;
    uint8_t type = p[off++];
    uint32_t klen;
    if (!get_u32(p, n, off, &klen) || off + klen > n) return false;
    off += klen;
    if (type == 0) {
      uint32_t vlen;
      if (!get_u32(p, n, off, &vlen) || off + vlen > n) return false;
      off += vlen;
    } else if (type != 1) {
      return false;
    }
  }
  return off == n;
}

static std::string kv_wal_path(const KvStore* kv) { return kv->dir + "/kv.wal"; }
static std::string kv_sst_path(const KvStore* kv) { return kv->dir + "/kv.sst"; }

static bool read_file(const std::string& path, std::string* out) {
  int fd = ::open(path.c_str(), O_RDONLY);
  if (fd < 0) return false;
  struct stat st;
  if (fstat(fd, &st) != 0) { ::close(fd); return false; }
  out->resize(st.st_size);
  size_t got = 0;
  while (got < out->size()) {
    ssize_t r = ::read(fd, &(*out)[got], out->size() - got);
    if (r <= 0) { ::close(fd); return false; }
    got += r;
  }
  ::close(fd);
  return true;
}

// Load the snapshot (if any): magic, version, seq, count,
// (klen, key, vlen, val)*, trailing crc32c over everything before it.
static bool kv_load_snapshot(KvStore* kv) {
  std::string buf;
  if (!read_file(kv_sst_path(kv), &buf)) return true;  // no snapshot: fine
  if (buf.size() < 24) return false;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(buf.data());
  size_t n = buf.size();
  uint32_t want;
  memcpy(&want, p + n - 4, 4);
  if (crc32c(0, p, n - 4) != want) return false;
  size_t off = 0;
  uint32_t magic, ver;
  uint64_t seq, count;
  if (!get_u32(p, n, off, &magic) || magic != KV_SNAP_MAGIC) return false;
  if (!get_u32(p, n, off, &ver) || ver != KV_SNAP_VERSION) return false;
  if (!get_u64(p, n, off, &seq)) return false;
  if (!get_u64(p, n, off, &count)) return false;
  for (uint64_t i = 0; i < count; i++) {
    uint32_t klen, vlen;
    if (!get_u32(p, n, off, &klen) || off + klen > n) return false;
    std::string key(reinterpret_cast<const char*>(p + off), klen);
    off += klen;
    if (!get_u32(p, n, off, &vlen) || off + vlen > n) return false;
    kv->data[std::move(key)].assign(
        reinterpret_cast<const char*>(p + off), vlen);
    off += vlen;
  }
  kv->seq = seq;
  return true;
}

// Replay the WAL; returns the byte offset one past the last intact
// record (torn tails are truncated by the caller). Records below the
// snapshot watermark are skipped (idempotent replay after a crash
// inside compaction).
static uint64_t kv_replay_wal(KvStore* kv, const std::string& buf) {
  const uint8_t* p = reinterpret_cast<const uint8_t*>(buf.data());
  size_t n = buf.size(), off = 0;
  while (off + 8 <= n) {
    uint32_t len = 0, want = 0;
    size_t o = off;
    get_u32(p, n, o, &len);
    get_u32(p, n, o, &want);
    if (o + len > n) break;
    if (crc32c(0, p + o, len) != want) break;
    size_t bo = o;
    uint64_t seq;
    if (!get_u64(p, n, bo, &seq)) break;
    if (seq > kv->seq) {
      if (!apply_batch(kv, p + bo, o + len - bo)) break;
      kv->seq = seq;
    }
    off = o + len;
  }
  return off;
}

static int kv_write_all(int fd, const void* buf, size_t len) {
  const char* p = static_cast<const char*>(buf);
  while (len) {
    ssize_t w = ::write(fd, p, len);
    if (w <= 0) return -1;
    p += w;
    len -= w;
  }
  return 0;
}

}  // namespace

extern "C" {

void* ctkv_open(const char* dir, int do_fsync) {
  auto* kv = new KvStore;
  kv->dir = dir;
  kv->do_fsync = do_fsync != 0;
  ::mkdir(dir, 0755);
  if (!kv_load_snapshot(kv)) { delete kv; return nullptr; }
  std::string wal;
  uint64_t valid = 0;
  if (read_file(kv_wal_path(kv), &wal)) valid = kv_replay_wal(kv, wal);
  kv->wal_fd = ::open(kv_wal_path(kv).c_str(), O_RDWR | O_CREAT, 0644);
  if (kv->wal_fd < 0) { delete kv; return nullptr; }
  // discard any torn tail NOW so later appends stay reachable to replay
  if (ftruncate(kv->wal_fd, valid) != 0 ||
      lseek(kv->wal_fd, valid, SEEK_SET) < 0) {
    ::close(kv->wal_fd);
    delete kv;
    return nullptr;
  }
  kv->wal_size = valid;
  return kv;
}

void ctkv_close(void* h) {
  auto* kv = static_cast<KvStore*>(h);
  if (!kv) return;
  if (kv->wal_fd >= 0) ::close(kv->wal_fd);
  delete kv;
}

// Atomic batch: appended to the WAL (one CRC-framed record), then
// applied to the map. Returns 0 on success.
int ctkv_batch(void* h, const uint8_t* payload, uint64_t len) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  // structural validation first: a malformed batch must not half-apply
  // (apply_batch can only fail on framing, never on map state)
  if (!validate_batch(payload, len)) return -1;
  std::string body;
  put_u64(body, kv->seq + 1);
  body.append(reinterpret_cast<const char*>(payload), len);
  std::string rec;
  put_u32(rec, static_cast<uint32_t>(body.size()));
  put_u32(rec, crc32c(0, body.data(), body.size()));
  rec += body;
  // pwrite at the tracked tail; a partial write (ENOSPC/EIO) must not
  // leave torn bytes that later successful appends would land after —
  // that would make every subsequent acked record unreachable to replay
  size_t done = 0;
  while (done < rec.size()) {
    ssize_t w = ::pwrite(kv->wal_fd, rec.data() + done, rec.size() - done,
                         kv->wal_size + done);
    if (w <= 0) {
      ftruncate(kv->wal_fd, kv->wal_size);
      return -2;
    }
    done += w;
  }
  if (kv->do_fsync) fdatasync(kv->wal_fd);
  kv->wal_size += rec.size();
  apply_batch(kv, payload, len);
  kv->seq++;
  return 0;
}

int ctkv_put(void* h, const uint8_t* k, uint32_t klen, const uint8_t* v,
             uint32_t vlen) {
  std::string payload;
  put_u32(payload, 1);
  payload.push_back(0);
  put_u32(payload, klen);
  payload.append(reinterpret_cast<const char*>(k), klen);
  put_u32(payload, vlen);
  payload.append(reinterpret_cast<const char*>(v), vlen);
  return ctkv_batch(h, reinterpret_cast<const uint8_t*>(payload.data()),
                    payload.size());
}

int ctkv_del(void* h, const uint8_t* k, uint32_t klen) {
  std::string payload;
  put_u32(payload, 1);
  payload.push_back(1);
  put_u32(payload, klen);
  payload.append(reinterpret_cast<const char*>(k), klen);
  return ctkv_batch(h, reinterpret_cast<const uint8_t*>(payload.data()),
                    payload.size());
}

// Returns a malloc'd copy of the value (caller frees via ctkv_buf_free)
// or nullptr if absent.
uint8_t* ctkv_get(void* h, const uint8_t* k, uint32_t klen, uint64_t* vlen) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  auto it = kv->data.find(std::string(reinterpret_cast<const char*>(k), klen));
  if (it == kv->data.end()) return nullptr;
  *vlen = it->second.size();
  auto* out = static_cast<uint8_t*>(malloc(it->second.size() + 1));
  memcpy(out, it->second.data(), it->second.size());
  return out;
}

void ctkv_buf_free(uint8_t* p) { free(p); }

// Range scan [lo, hi): returns a malloc'd packed buffer of
// (u32 klen, key, u32 vlen, val)* and sets *count / *buflen. An empty
// hi means "to the end". Caller frees via ctkv_buf_free.
uint8_t* ctkv_scan(void* h, const uint8_t* lo, uint32_t lolen,
                   const uint8_t* hi, uint32_t hilen, uint64_t max_items,
                   uint64_t* count, uint64_t* buflen) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  std::string klo(reinterpret_cast<const char*>(lo), lolen);
  std::string khi(reinterpret_cast<const char*>(hi), hilen);
  auto it = kv->data.lower_bound(klo);
  auto end = hilen ? kv->data.lower_bound(khi) : kv->data.end();
  std::string out;
  uint64_t n = 0;
  for (; it != end && n < max_items; ++it, ++n) {
    put_u32(out, static_cast<uint32_t>(it->first.size()));
    out += it->first;
    put_u32(out, static_cast<uint32_t>(it->second.size()));
    out += it->second;
  }
  *count = n;
  *buflen = out.size();
  auto* buf = static_cast<uint8_t*>(malloc(out.size() + 1));
  memcpy(buf, out.data(), out.size());
  return buf;
}

// Snapshot-then-truncate-WAL (the compaction role). Atomic via
// write-to-temp + rename.
int ctkv_compact(void* h) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  std::string blob;
  put_u32(blob, KV_SNAP_MAGIC);
  put_u32(blob, KV_SNAP_VERSION);
  put_u64(blob, kv->seq);
  put_u64(blob, kv->data.size());
  for (auto& [k, v] : kv->data) {
    put_u32(blob, static_cast<uint32_t>(k.size()));
    blob += k;
    put_u32(blob, static_cast<uint32_t>(v.size()));
    blob += v;
  }
  put_u32(blob, crc32c(0, blob.data(), blob.size()));
  std::string tmp = kv_sst_path(kv) + ".tmp." + std::to_string(getpid());
  int fd = ::open(tmp.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -1;
  if (kv_write_all(fd, blob.data(), blob.size()) != 0) {
    ::close(fd);
    unlink(tmp.c_str());
    return -1;
  }
  fsync(fd);
  ::close(fd);
  if (rename(tmp.c_str(), kv_sst_path(kv).c_str()) != 0) return -1;
  // persist the rename's directory entry BEFORE truncating the WAL: a
  // power cut must never see (old snapshot, empty WAL)
  int dirfd = ::open(kv->dir.c_str(), O_RDONLY | O_DIRECTORY);
  if (dirfd >= 0) {
    fsync(dirfd);
    ::close(dirfd);
  }
  if (ftruncate(kv->wal_fd, 0) != 0) return -1;
  if (kv->do_fsync) fdatasync(kv->wal_fd);
  kv->wal_size = 0;
  return 0;
}

uint64_t ctkv_count(void* h) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  return kv->data.size();
}

uint64_t ctkv_wal_size(void* h) {
  auto* kv = static_cast<KvStore*>(h);
  std::lock_guard<std::mutex> g(kv->mu);
  return kv->wal_size;
}

}  // extern "C"

// ------------------------------------------------------------------ blk

namespace {

struct BlkJob {
  uint64_t off;
  std::string data;
};

struct BlkDev {
  int fd = -1;
  uint64_t size = 0;
  std::vector<std::thread> workers;
  std::queue<BlkJob> jobs;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  uint64_t submitted = 0, completed = 0;
  int first_error = 0;
  bool stopping = false;

  void worker() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv_work.wait(lk, [&] { return stopping || !jobs.empty(); });
      if (jobs.empty()) {
        if (stopping) return;
        continue;
      }
      BlkJob job = std::move(jobs.front());
      jobs.pop();
      lk.unlock();
      int err = 0;
      size_t done = 0;
      while (done < job.data.size()) {
        ssize_t w = ::pwrite(fd, job.data.data() + done,
                             job.data.size() - done, job.off + done);
        if (w <= 0) { err = errno ? errno : 5; break; }
        done += w;
      }
      lk.lock();
      completed++;
      if (err && !first_error) first_error = err;
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* ctblk_open(const char* path, uint64_t size, int n_threads) {
  auto* d = new BlkDev;
  d->fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (d->fd < 0) { delete d; return nullptr; }
  struct stat st;
  fstat(d->fd, &st);
  if (static_cast<uint64_t>(st.st_size) < size) {
    if (ftruncate(d->fd, size) != 0) {  // sparse: no real disk cost
      ::close(d->fd);
      delete d;
      return nullptr;
    }
    d->size = size;
  } else {
    d->size = st.st_size;
  }
  if (n_threads < 1) n_threads = 1;
  for (int i = 0; i < n_threads; i++)
    d->workers.emplace_back([d] { d->worker(); });
  return d;
}

void ctblk_close(void* h) {
  auto* d = static_cast<BlkDev*>(h);
  if (!d) return;
  {
    std::lock_guard<std::mutex> g(d->mu);
    d->stopping = true;
  }
  d->cv_work.notify_all();
  for (auto& t : d->workers) t.join();
  if (d->fd >= 0) ::close(d->fd);
  delete d;
}

uint64_t ctblk_size(void* h) { return static_cast<BlkDev*>(h)->size; }

// Async write (data is copied; returns the submission ticket).
uint64_t ctblk_submit_write(void* h, uint64_t off, const uint8_t* buf,
                            uint64_t len) {
  auto* d = static_cast<BlkDev*>(h);
  std::lock_guard<std::mutex> g(d->mu);
  d->jobs.push(BlkJob{off, std::string(reinterpret_cast<const char*>(buf),
                                       len)});
  d->submitted++;
  d->cv_work.notify_one();
  return d->submitted;
}

// Block until every submitted write has completed; returns the first
// errno seen (sticky) or 0.
int ctblk_drain(void* h) {
  auto* d = static_cast<BlkDev*>(h);
  std::unique_lock<std::mutex> lk(d->mu);
  d->cv_done.wait(lk, [&] { return d->completed == d->submitted; });
  return d->first_error;
}

// Drain + fdatasync (the flush/barrier role).
int ctblk_flush(void* h) {
  int err = ctblk_drain(h);
  auto* d = static_cast<BlkDev*>(h);
  if (fdatasync(d->fd) != 0 && !err) err = errno;
  return err;
}

int ctblk_pwrite(void* h, uint64_t off, const uint8_t* buf, uint64_t len) {
  auto* d = static_cast<BlkDev*>(h);
  size_t done = 0;
  while (done < len) {
    ssize_t w = ::pwrite(d->fd, buf + done, len - done, off + done);
    if (w <= 0) return errno ? errno : 5;
    done += w;
  }
  return 0;
}

int ctblk_pread(void* h, uint64_t off, uint8_t* buf, uint64_t len) {
  auto* d = static_cast<BlkDev*>(h);
  size_t done = 0;
  while (done < len) {
    ssize_t r = ::pread(d->fd, buf + done, len - done, off + done);
    if (r < 0) return errno ? errno : 5;
    if (r == 0) {  // past EOF on a sparse file: zeros
      memset(buf + done, 0, len - done);
      return 0;
    }
    done += r;
  }
  return 0;
}

}  // extern "C"

// ------------------------------------------------------------ allocator

namespace {

struct Alloc {
  std::vector<uint64_t> bits;  // 1 = used
  uint64_t n_blocks = 0;
  uint64_t n_used = 0;
  uint64_t cursor = 0;  // first-fit scan hint
  std::mutex mu;

  bool test(uint64_t i) const { return (bits[i >> 6] >> (i & 63)) & 1; }
  void set(uint64_t i) { bits[i >> 6] |= 1ULL << (i & 63); }
  void clr(uint64_t i) { bits[i >> 6] &= ~(1ULL << (i & 63)); }
};

}  // namespace

extern "C" {

void* ctalloc_new(uint64_t n_blocks) {
  auto* a = new Alloc;
  a->n_blocks = n_blocks;
  a->bits.assign((n_blocks + 63) / 64, 0);
  return a;
}

void ctalloc_free_handle(void* h) { delete static_cast<Alloc*>(h); }

// First-fit contiguous run of n blocks, scanning from the cursor and
// wrapping once. Returns the start block or UINT64_MAX if no fit.
uint64_t ctalloc_alloc(void* h, uint64_t n) {
  auto* a = static_cast<Alloc*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  if (n == 0 || a->n_used + n > a->n_blocks) return UINT64_MAX;
  for (int pass = 0; pass < 2; pass++) {
    uint64_t start = pass == 0 ? a->cursor : 0;
    uint64_t limit = pass == 0 ? a->n_blocks : a->cursor;
    uint64_t run = 0, run_start = 0;
    for (uint64_t i = start; i < limit; i++) {
      // skip whole free/used words when possible (the fastbmap trick)
      if ((i & 63) == 0 && i + 64 <= limit) {
        uint64_t w = a->bits[i >> 6];
        if (w == ~0ULL) { run = 0; i += 63; continue; }
        if (w == 0 && run + 64 < n) {
          if (run == 0) run_start = i;
          run += 64;
          i += 63;
          continue;
        }
      }
      if (a->test(i)) {
        run = 0;
      } else {
        if (run == 0) run_start = i;
        if (++run == n) {
          for (uint64_t b = run_start; b < run_start + n; b++) a->set(b);
          a->n_used += n;
          a->cursor = run_start + n;
          return run_start;
        }
      }
    }
  }
  return UINT64_MAX;
}

void ctalloc_release(void* h, uint64_t start, uint64_t n) {
  auto* a = static_cast<Alloc*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  for (uint64_t i = start; i < start + n && i < a->n_blocks; i++) {
    if (a->test(i)) {
      a->clr(i);
      a->n_used--;
    }
  }
  if (start < a->cursor) a->cursor = start;
}

// Mount-time rebuild: mark an extent in-use (idempotent).
void ctalloc_mark_used(void* h, uint64_t start, uint64_t n) {
  auto* a = static_cast<Alloc*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  for (uint64_t i = start; i < start + n && i < a->n_blocks; i++) {
    if (!a->test(i)) {
      a->set(i);
      a->n_used++;
    }
  }
}

uint64_t ctalloc_used(void* h) {
  auto* a = static_cast<Alloc*>(h);
  std::lock_guard<std::mutex> g(a->mu);
  return a->n_used;
}

uint64_t ctalloc_total(void* h) { return static_cast<Alloc*>(h)->n_blocks; }

}  // extern "C"
