// lighthouse-tpu native KV store (the PyTorch port builds it with g++ at first use).
//
// Fills the role LevelDB (C++ via leveldb-sys) plays for the reference's
// hot/cold databases (lighthouse/beacon_node/store/src/leveldb_store.rs)
// — but as a purpose-built log-structured store: an append-only record log
// with CRC framing, an in-memory hash index rebuilt on open, atomic
// multi-op batches (one framed record), and stop-the-world compaction.
// That matches the access pattern of a beacon node store (point lookups by
// 32-byte root, bulk sequential writes, occasional prune/compact) without
// dragging in an external dependency.
//
// C ABI (ctypes-friendly): every function returns 0 on success or a
// negative errno-style code. Buffers are length-prefixed; get() copies into
// a malloc'd buffer the caller frees with kvs_free().
//
// Build (the tracked libltkv.so next to this file):
//   g++ -std=c++17 -O2 -shared -fPIC -o libltkv.so kv_store.cc

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <string>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4C544B56;  // "LTKV"
constexpr uint8_t kOpPut = 1;
constexpr uint8_t kOpDel = 2;
constexpr uint8_t kOpBatchEnd = 3;

uint32_t crc32(const uint8_t* data, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++) c = table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

// fsync policy on the append path (mirrors store/native_kv.py):
// 0 = never (page cache only), 1 = batch (every kFsyncBatchEvery records
// and on kvs_flush), 2 = always (every record).
constexpr int kFsyncNever = 0;
constexpr int kFsyncBatch = 1;
constexpr int kFsyncAlways = 2;
constexpr int kFsyncBatchEvery = 64;

struct Store {
  std::mutex mu;
  std::string path;
  FILE* log = nullptr;
  // key -> value (values stay in memory; the log is the durable copy).
  std::unordered_map<std::string, std::string> index;
  uint64_t dead_bytes = 0;
  uint64_t live_bytes = 0;
  int fsync_mode = kFsyncBatch;
  int unsynced = 0;

  ~Store() {
    if (log) {
      fflush(log);
      if (fsync_mode != kFsyncNever) fsync(fileno(log));
      fclose(log);
    }
  }
};

void fsync_dir_of(const std::string& path) {
  // persist the directory entry after a rename/create; the file's own
  // fsync does not cover it
  size_t slash = path.find_last_of('/');
  std::string dir = (slash == std::string::npos) ? "." : path.substr(0, slash);
  int fd = open(dir.c_str(), O_RDONLY);
  if (fd >= 0) {
    fsync(fd);
    close(fd);
  }
}

void apply_fsync_policy(Store* s) {
  if (s->fsync_mode == kFsyncAlways) {
    fsync(fileno(s->log));
  } else if (s->fsync_mode == kFsyncBatch) {
    if (++s->unsynced >= kFsyncBatchEvery) {
      fsync(fileno(s->log));
      s->unsynced = 0;
    }
  }
}

// Record: [u32 crc over rest][u32 payload_len][payload]
// payload: sequence of ops: [u8 op][u32 klen][u32 vlen][key][value]
bool write_record(Store* s, const std::string& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  uint32_t crc = crc32(reinterpret_cast<const uint8_t*>(payload.data()), payload.size());
  if (fwrite(&crc, 4, 1, s->log) != 1) return false;
  if (fwrite(&len, 4, 1, s->log) != 1) return false;
  if (len && fwrite(payload.data(), 1, len, s->log) != len) return false;
  if (fflush(s->log) != 0) return false;
  return true;
}

void append_op(std::string* payload, uint8_t op, const std::string& k, const std::string& v) {
  uint32_t klen = static_cast<uint32_t>(k.size());
  uint32_t vlen = static_cast<uint32_t>(v.size());
  payload->push_back(static_cast<char>(op));
  payload->append(reinterpret_cast<const char*>(&klen), 4);
  payload->append(reinterpret_cast<const char*>(&vlen), 4);
  payload->append(k);
  payload->append(v);
}

void apply_payload(Store* s, const std::string& payload) {
  size_t pos = 0;
  while (pos + 9 <= payload.size()) {
    uint8_t op = static_cast<uint8_t>(payload[pos]);
    uint32_t klen, vlen;
    memcpy(&klen, payload.data() + pos + 1, 4);
    memcpy(&vlen, payload.data() + pos + 5, 4);
    pos += 9;
    if (pos + klen + vlen > payload.size()) return;  // truncated
    std::string key(payload.data() + pos, klen);
    pos += klen;
    std::string val(payload.data() + pos, vlen);
    pos += vlen;
    if (op == kOpPut) {
      auto it = s->index.find(key);
      if (it != s->index.end()) s->dead_bytes += it->second.size() + key.size();
      s->live_bytes += key.size() + val.size();
      s->index[key] = std::move(val);
    } else if (op == kOpDel) {
      auto it = s->index.find(key);
      if (it != s->index.end()) {
        s->dead_bytes += it->second.size() + key.size();
        s->live_bytes -= it->second.size() + key.size();
        s->index.erase(it);
      }
    }
  }
}

bool load_log(Store* s) {
  FILE* f = fopen(s->path.c_str(), "rb");
  if (!f) return true;  // fresh store
  fseek(f, 0, SEEK_END);
  long file_end = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint32_t header[2];
  std::string payload;
  long valid_end = 0;
  while (fread(header, 4, 2, f) == 2) {
    uint32_t crc = header[0], len = header[1];
    // bound the untrusted length by what the file can hold BEFORE the
    // allocation: a torn header can claim a multi-GiB payload, and a
    // bad_alloc cannot cross the C ABI
    if ((long)len > file_end - valid_end - 8) break;  // truncated tail
    payload.resize(len);
    if (len && fread(payload.data(), 1, len, f) != len) break;  // truncated tail
    if (crc32(reinterpret_cast<const uint8_t*>(payload.data()), len) != crc)
      break;  // corrupt tail: stop replay (crash-consistent prefix wins)
    apply_payload(s, payload);
    valid_end = ftell(f);
  }
  fclose(f);
  // drop the corrupt/truncated tail BEFORE appending (parity with the
  // pure-Python engine): a record appended after garbage would be
  // unreachable on the next replay — the scanner stops at the bad record —
  // silently losing every post-recovery write
  if (file_end > valid_end) {
    if (truncate(s->path.c_str(), valid_end) != 0) return false;
  }
  return true;
}

}  // namespace

extern "C" {

void* kvs_open(const char* path) {
  auto* s = new Store();
  s->path = path;
  // a crash mid-compaction leaks its tmp; it was never the live DB
  remove((s->path + ".compact").c_str());
  if (!load_log(s)) {
    delete s;
    return nullptr;
  }
  s->log = fopen(path, "ab");
  if (!s->log) {
    delete s;
    return nullptr;
  }
  return s;
}

void kvs_close(void* h) { delete static_cast<Store*>(h); }

int kvs_put(void* h, const uint8_t* key, uint32_t klen, const uint8_t* val, uint32_t vlen) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string payload;
  append_op(&payload, kOpPut, std::string((const char*)key, klen),
            std::string((const char*)val, vlen));
  if (!write_record(s, payload)) return -5;
  apply_fsync_policy(s);
  apply_payload(s, payload);
  return 0;
}

int kvs_delete(void* h, const uint8_t* key, uint32_t klen) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string payload;
  append_op(&payload, kOpDel, std::string((const char*)key, klen), "");
  if (!write_record(s, payload)) return -5;
  apply_fsync_policy(s);
  apply_payload(s, payload);
  return 0;
}

// batch: flat buffer of ops in the payload format described above.
int kvs_batch(void* h, const uint8_t* payload, uint32_t len) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string p((const char*)payload, len);
  if (!write_record(s, p)) return -5;
  apply_fsync_policy(s);
  apply_payload(s, p);
  return 0;
}

// mode: 0 = never, 1 = batch (default), 2 = always.
int kvs_set_fsync(void* h, int mode) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (mode < kFsyncNever || mode > kFsyncAlways) return -22;
  s->fsync_mode = mode;
  return 0;
}

// Durability barrier: everything written so far is on disk on return.
int kvs_flush(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (!s->log) return -5;
  if (fflush(s->log) != 0) return -5;
  if (s->fsync_mode != kFsyncNever && fsync(fileno(s->log)) != 0) return -5;
  s->unsynced = 0;
  return 0;
}

// Returns 0 + malloc'd *val (caller frees via kvs_free), -1 if missing.
int kvs_get(void* h, const uint8_t* key, uint32_t klen, uint8_t** val, uint32_t* vlen) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  auto it = s->index.find(std::string((const char*)key, klen));
  if (it == s->index.end()) return -1;
  *vlen = static_cast<uint32_t>(it->second.size());
  *val = static_cast<uint8_t*>(malloc(it->second.size() ? it->second.size() : 1));
  memcpy(*val, it->second.data(), it->second.size());
  return 0;
}

void kvs_free(uint8_t* p) { free(p); }

uint64_t kvs_count(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->index.size();
}

// Iterate keys with a prefix; calls back with (key, klen, val, vlen).
typedef void (*kvs_iter_cb)(void* ctx, const uint8_t* key, uint32_t klen,
                            const uint8_t* val, uint32_t vlen);

int kvs_iter_prefix(void* h, const uint8_t* prefix, uint32_t plen, kvs_iter_cb cb, void* ctx) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  // sorted iteration for deterministic order
  std::map<std::string, const std::string*> sorted;
  std::string pref((const char*)prefix, plen);
  for (auto& kv : s->index) {
    if (kv.first.compare(0, pref.size(), pref) == 0) sorted[kv.first] = &kv.second;
  }
  for (auto& kv : sorted) {
    cb(ctx, (const uint8_t*)kv.first.data(), (uint32_t)kv.first.size(),
       (const uint8_t*)kv.second->data(), (uint32_t)kv.second->size());
  }
  return 0;
}

// Rewrite the log with only live records (stop-the-world). Crash-safe:
// the tmp is fsynced BEFORE the rename (a power loss after the rename
// must find the new bytes, not a zero-length inode) and the directory
// entry is fsynced after; a crash at any point leaves either the old log
// or the complete new one (the stale tmp is swept at the next open).
int kvs_compact(void* h) {
  auto* s = static_cast<Store*>(h);
  std::lock_guard<std::mutex> g(s->mu);
  std::string tmp_path = s->path + ".compact";
  FILE* tmp = fopen(tmp_path.c_str(), "wb");
  if (!tmp) return -5;
  FILE* old = s->log;
  s->log = tmp;
  bool ok = true;
  for (auto& kv : s->index) {
    std::string payload;
    append_op(&payload, kOpPut, kv.first, kv.second);
    if (!write_record(s, payload)) {
      ok = false;
      break;
    }
  }
  if (ok && s->fsync_mode != kFsyncNever && fsync(fileno(tmp)) != 0) ok = false;
  if (ok) {
    fclose(old);
    fclose(tmp);
    if (rename(tmp_path.c_str(), s->path.c_str()) != 0) ok = false;
    if (ok && s->fsync_mode != kFsyncNever) fsync_dir_of(s->path);
    s->log = fopen(s->path.c_str(), "ab");
    s->dead_bytes = 0;
    s->unsynced = 0;
  } else {
    s->log = old;
    fclose(tmp);
    remove(tmp_path.c_str());
  }
  return ok ? 0 : -5;
}

}  // extern "C"
