// RecordIO-style chunked record file format — native C++ implementation
// (the port's own copy of paddle_tpu/recordio/recordio.cc; the on-disk
// format is the same byte for byte, so files interchange between the
// packages).
//
// Capability-equivalent of PaddlePaddle Fluid's RecordIO stack
// (paddle/fluid/recordio/{header.h,chunk.h,writer.h,scanner.h}): an
// append-only sequence of chunks, each holding many small records, with
// per-chunk CRC32 integrity and optional zlib compression. The on-disk
// layout is
//
//   chunk := magic:u32 | compressor:u32 | num_records:u32
//          | raw_len:u32 | payload_len:u32 | crc32(payload):u32
//          | payload bytes
//   payload (after decompression) := (len:u32 | bytes)*
//
// all little-endian. Readers skip trailing garbage (a torn final chunk
// from a crashed writer) by CRC validation, which is Fluid's recovery
// story too.
//
// Exposed as a flat C ABI for ctypes (no pybind11);
// paddle_tpu_torch/recordio/recordio.py builds this file on demand
// through utils/native.py (`g++ -O2 -shared -fPIC recordio.cc -lz`) and
// falls back to a pure-Python implementation of the same format when no
// toolchain exists.

#include <errno.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

#include <atomic>
#include <condition_variable>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x50545231;  // "PTR1"
constexpr uint32_t kNoCompress = 0;
constexpr uint32_t kZlib = 1;

struct Writer {
  FILE* f = nullptr;
  uint32_t compressor = kNoCompress;
  size_t max_chunk = 1 << 20;  // flush payload at ~1 MiB
  std::vector<uint8_t> buf;    // raw payload being accumulated
  uint32_t num_records = 0;
  std::string error;
};

struct Scanner {
  FILE* f = nullptr;
  std::vector<uint8_t> chunk;  // decompressed payload of current chunk
  size_t pos = 0;              // cursor into chunk
  std::string error;
};

void put_u32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 24) & 0xff);
}

uint32_t get_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

bool flush_chunk(Writer* w) {
  if (w->num_records == 0) return true;
  const std::vector<uint8_t>& raw = w->buf;
  std::vector<uint8_t> payload;
  uint32_t compressor = w->compressor;
  if (compressor == kZlib) {
    uLongf bound = compressBound(raw.size());
    payload.resize(bound);
    if (compress2(payload.data(), &bound, raw.data(), raw.size(),
                  Z_DEFAULT_COMPRESSION) != Z_OK) {
      w->error = "zlib compress failed";
      return false;
    }
    payload.resize(bound);
  } else {
    payload = raw;
  }
  uint32_t crc = crc32(0L, payload.data(), payload.size());
  std::vector<uint8_t> head;
  put_u32(head, kMagic);
  put_u32(head, compressor);
  put_u32(head, w->num_records);
  put_u32(head, (uint32_t)raw.size());
  put_u32(head, (uint32_t)payload.size());
  put_u32(head, crc);
  if (fwrite(head.data(), 1, head.size(), w->f) != head.size() ||
      fwrite(payload.data(), 1, payload.size(), w->f) != payload.size()) {
    w->error = std::string("write failed: ") + strerror(errno);
    return false;
  }
  w->buf.clear();
  w->num_records = 0;
  return true;
}

bool load_chunk(Scanner* s) {
  uint8_t head[24];
  size_t n = fread(head, 1, sizeof(head), s->f);
  if (n == 0) return false;  // clean EOF
  if (n != sizeof(head) || get_u32(head) != kMagic) {
    s->error = n == sizeof(head) ? "bad chunk magic" : "torn chunk header";
    return false;
  }
  uint32_t compressor = get_u32(head + 4);
  uint32_t raw_len = get_u32(head + 12);
  uint32_t payload_len = get_u32(head + 16);
  uint32_t crc_want = get_u32(head + 20);
  std::vector<uint8_t> payload(payload_len);
  if (fread(payload.data(), 1, payload_len, s->f) != payload_len) {
    s->error = "torn chunk payload";
    return false;
  }
  if (crc32(0L, payload.data(), payload.size()) != crc_want) {
    s->error = "chunk crc mismatch";
    return false;
  }
  if (compressor == kZlib) {
    s->chunk.resize(raw_len);
    uLongf out = raw_len;
    if (uncompress(s->chunk.data(), &out, payload.data(), payload.size()) !=
            Z_OK ||
        out != raw_len) {
      s->error = "zlib uncompress failed";
      return false;
    }
  } else {
    s->chunk = std::move(payload);
  }
  s->pos = 0;
  return true;
}

struct Prefetcher {
  std::vector<std::string> paths;
  std::deque<std::vector<uint8_t>> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t capacity = 1024;
  int active = 0;
  bool closing = false;
  std::string error;            // written by workers under mu
  std::string error_out;        // consumer-owned snapshot (see _error)
  std::vector<std::thread> threads;
  std::atomic<size_t> next_path{0};
  std::vector<uint8_t> current;
};

}  // namespace

extern "C" {

// ---- writer ----
void* rio_writer_open(const char* path, uint32_t compressor,
                      uint32_t max_chunk_bytes) {
  Writer* w = new Writer();
  w->f = fopen(path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  w->compressor = compressor ? kZlib : kNoCompress;
  if (max_chunk_bytes) w->max_chunk = max_chunk_bytes;
  return w;
}

int rio_write(void* wp, const uint8_t* data, uint32_t len) {
  Writer* w = (Writer*)wp;
  put_u32(w->buf, len);
  w->buf.insert(w->buf.end(), data, data + len);
  w->num_records++;
  if (w->buf.size() >= w->max_chunk) return flush_chunk(w) ? 0 : -1;
  return 0;
}

int rio_writer_close(void* wp) {
  Writer* w = (Writer*)wp;
  int rc = flush_chunk(w) ? 0 : -1;
  if (w->f) fclose(w->f);
  delete w;
  return rc;
}

// ---- scanner ----
void* rio_scanner_open(const char* path) {
  Scanner* s = new Scanner();
  s->f = fopen(path, "rb");
  if (!s->f) {
    delete s;
    return nullptr;
  }
  return s;
}

// Returns record length >= 0 and sets *out to an internal buffer valid
// until the next call; -1 at EOF; -2 on corruption (error via rio_error).
int64_t rio_next(void* sp, const uint8_t** out) {
  Scanner* s = (Scanner*)sp;
  while (s->pos >= s->chunk.size()) {
    s->chunk.clear();
    s->pos = 0;
    if (!load_chunk(s)) return s->error.empty() ? -1 : -2;
  }
  if (s->pos + 4 > s->chunk.size()) {
    s->error = "truncated record length";
    return -2;
  }
  uint32_t len = get_u32(s->chunk.data() + s->pos);
  s->pos += 4;
  if (s->pos + len > s->chunk.size()) {
    s->error = "truncated record body";
    return -2;
  }
  *out = s->chunk.data() + s->pos;
  s->pos += len;
  return (int64_t)len;
}

const char* rio_error(void* sp) { return ((Scanner*)sp)->error.c_str(); }

void rio_scanner_close(void* sp) {
  Scanner* s = (Scanner*)sp;
  if (s->f) fclose(s->f);
  delete s;
}

// Count records without materialising them (index pass).
int64_t rio_count(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t total = 0;
  uint8_t head[24];
  while (fread(head, 1, sizeof(head), f) == sizeof(head)) {
    if (get_u32(head) != kMagic) break;
    total += get_u32(head + 8);
    if (fseek(f, get_u32(head + 16), SEEK_CUR) != 0) break;
  }
  fclose(f);
  return total;
}

// ---- multi-file background prefetcher ----
// Fluid's async reader tier (operators/reader/open_files_op.cc
// multi-file parallel reader, buffered_reader.h double buffering,
// ctr_reader.h dedicated reader threads): N worker threads scan a list
// of recordio files and push records into a bounded queue; the consumer
// pops without touching the filesystem. Single-consumer contract (the
// popped record stays valid until the next rio_prefetch_next call).

void* rio_prefetch_open(const char** paths, int n_paths, int n_threads,
                        int queue_capacity) {
  Prefetcher* p = new Prefetcher();
  for (int i = 0; i < n_paths; i++) p->paths.emplace_back(paths[i]);
  p->capacity = queue_capacity > 0 ? (size_t)queue_capacity : 1024;
  int nt = n_threads > 0 ? n_threads : 2;
  if (nt > n_paths) nt = n_paths;
  p->active = nt;
  for (int t = 0; t < nt; t++) {
    p->threads.emplace_back([p]() {
      for (;;) {
        size_t idx = p->next_path.fetch_add(1);
        if (idx >= p->paths.size()) break;
        void* sc = rio_scanner_open(p->paths[idx].c_str());
        if (!sc) {
          std::lock_guard<std::mutex> g(p->mu);
          if (p->error.empty())
            p->error = "cannot open " + p->paths[idx];
          p->cv_pop.notify_all();
          break;
        }
        const uint8_t* rec = nullptr;
        int64_t len;
        while ((len = rio_next(sc, &rec)) >= 0) {
          std::unique_lock<std::mutex> g(p->mu);
          p->cv_push.wait(g, [p] {
            return p->queue.size() < p->capacity || p->closing;
          });
          if (p->closing) {
            g.unlock();
            rio_scanner_close(sc);
            goto done;
          }
          p->queue.emplace_back(rec, rec + len);
          p->cv_pop.notify_one();
        }
        if (len == -2) {
          std::lock_guard<std::mutex> g(p->mu);
          if (p->error.empty())
            p->error = std::string("corrupt file ") + p->paths[idx] +
                       ": " + rio_error(sc);
        }
        rio_scanner_close(sc);
      }
    done:
      std::lock_guard<std::mutex> g(p->mu);
      if (--p->active == 0) p->cv_pop.notify_all();
    });
  }
  return p;
}

// Returns record length >= 0 (record in *out, valid until next call),
// -1 when all files are exhausted, -2 on error (rio_prefetch_error).
int64_t rio_prefetch_next(void* pp, const uint8_t** out) {
  Prefetcher* p = (Prefetcher*)pp;
  std::unique_lock<std::mutex> g(p->mu);
  p->cv_pop.wait(g, [p] {
    return !p->queue.empty() || p->active == 0 || !p->error.empty();
  });
  if (!p->error.empty() && p->queue.empty()) return -2;
  if (p->queue.empty()) return -1;
  p->current = std::move(p->queue.front());
  p->queue.pop_front();
  p->cv_push.notify_one();
  *out = p->current.data();
  return (int64_t)p->current.size();
}

const char* rio_prefetch_error(void* pp) {
  // Snapshot under the lock into a consumer-owned buffer: workers may
  // still be assigning `error` concurrently, and handing out its c_str()
  // unlocked would race the reallocation. Single-consumer contract:
  // only the popping thread calls this.
  Prefetcher* p = (Prefetcher*)pp;
  std::lock_guard<std::mutex> g(p->mu);
  p->error_out = p->error;
  return p->error_out.c_str();
}

void rio_prefetch_close(void* pp) {
  Prefetcher* p = (Prefetcher*)pp;
  {
    std::lock_guard<std::mutex> g(p->mu);
    p->closing = true;
    p->cv_push.notify_all();
  }
  for (auto& t : p->threads) t.join();
  delete p;
}

}  // extern "C"
