// Native multi-slot text DataFeed (the port's own copy of
// paddle_tpu/data/datafeed.cc).
//
// Capability-equivalent of PaddlePaddle Fluid's C++ DataFeed tier
// (paddle/fluid/framework/data_feed.cc MultiSlotDataFeed: a
// protobuf-configured slot parser feeding training threads from text
// files):
//   - N worker threads each claim whole files from a shared counter,
//     parse slot-format lines, and assemble fixed-size batches locally
//     (no per-line locking); complete batches go through one bounded
//     queue with condition-variable backpressure.
//   - A batch is columnar: per slot a flat value array plus row-offset
//     table (CSR), which the Python side turns into padded-plus-mask
//     form.
//   - Flat C ABI for ctypes (no pybind11), built on demand through
//     paddle_tpu_torch/utils/native.py with -pthread.
//
// Line format (one example per line, slots in config order):
//   <n> v1 .. vn  <m> u1 .. um  ...
// Dense slots must have n == dim on every row; sparse slots vary.

#include <atomic>
#include <cctype>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::string name;
  bool is_float = false;
  bool dense = false;
  int dim = 1;
};

struct SlotBatch {
  std::vector<std::vector<float>> fvals;
  std::vector<std::vector<int64_t>> ivals;
  std::vector<std::vector<int64_t>> offsets;  // per slot, rows+1 entries
  int rows = 0;
  explicit SlotBatch(size_t nslots)
      : fvals(nslots), ivals(nslots), offsets(nslots) {
    for (auto& o : offsets) o.push_back(0);
  }
};

struct Feed {
  std::vector<Slot> slots;
  std::vector<std::string> files;
  int batch_size = 1;
  size_t queue_cap = 8;
  bool keep_partial = true;

  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  std::queue<SlotBatch*> ready;
  int active_workers = 0;
  std::atomic<bool> stop{false};  // set on close() and on first error
  std::string error;              // first error wins; read under mu
  std::atomic<size_t> next_file{0};
  std::vector<std::thread> workers;

  ~Feed() {
    stop.store(true);
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    while (!ready.empty()) {
      delete ready.front();
      ready.pop();
    }
  }

  void fail(const std::string& msg) {
    {
      std::lock_guard<std::mutex> l(mu);
      if (error.empty()) error = msg;
    }
    stop.store(true);
    cv_pop.notify_all();
  }

  // Push a finished batch; false when the feed stopped meanwhile.
  bool push(SlotBatch* b) {
    std::unique_lock<std::mutex> l(mu);
    cv_push.wait(l, [&] { return ready.size() < queue_cap || stop.load(); });
    if (stop.load()) {
      delete b;
      return false;
    }
    ready.push(b);
    cv_pop.notify_one();
    return true;
  }

  void worker() {
    auto batch = std::make_unique<SlotBatch>(slots.size());
    bool aborted = false;
    while (!aborted && !stop.load()) {
      size_t idx = next_file.fetch_add(1);
      if (idx >= files.size()) break;
      std::ifstream in(files[idx]);
      if (!in) {
        fail("cannot open " + files[idx]);
        aborted = true;
        break;
      }
      std::string line;
      size_t lineno = 0;
      while (std::getline(in, line)) {
        ++lineno;
        if (stop.load()) {
          aborted = true;
          break;
        }
        // strip trailing CR (CRLF files) and skip whitespace-only lines,
        // matching the Python fallback's `line.split()` behavior exactly
        while (!line.empty() &&
               (line.back() == '\r' || line.back() == '\n'))
          line.pop_back();
        bool blank = true;
        for (char c : line)
          if (!std::isspace(static_cast<unsigned char>(c))) {
            blank = false;
            break;
          }
        if (blank) continue;
        ++batch->rows;
        if (!parse_line(line, *batch)) {
          fail(files[idx] + ":" + std::to_string(lineno) +
               ": malformed slot line");
          aborted = true;
          break;
        }
        if (batch->rows == batch_size) {
          if (!push(batch.release())) {
            aborted = true;
            break;
          }
          batch = std::make_unique<SlotBatch>(slots.size());
        }
      }
    }
    if (!aborted && !stop.load() && keep_partial && batch->rows > 0)
      push(batch.release());
    std::lock_guard<std::mutex> l(mu);
    if (--active_workers == 0) cv_pop.notify_all();
  }

  bool parse_line(const std::string& line, SlotBatch& b) {
    const char* p = line.c_str();
    char* end = nullptr;
    for (size_t s = 0; s < slots.size(); ++s) {
      long n = std::strtol(p, &end, 10);
      if (end == p || n < 0) return false;
      p = end;
      const Slot& sl = slots[s];
      if (sl.dense && n != sl.dim) return false;
      for (long i = 0; i < n; ++i) {
        if (sl.is_float) {
          float v = std::strtof(p, &end);
          if (end == p) return false;
          b.fvals[s].push_back(v);
        } else {
          long long v = std::strtoll(p, &end, 10);
          if (end == p) return false;
          b.ivals[s].push_back(v);
        }
        p = end;
      }
      b.offsets[s].push_back(
          static_cast<int64_t>(sl.is_float ? b.fvals[s].size()
                                           : b.ivals[s].size()));
    }
    while (*p && std::isspace(static_cast<unsigned char>(*p))) ++p;
    return *p == '\0';  // trailing garbage = malformed
  }
};

// config: "name:dtype:kind[:dim];..." dtype in {float,int64},
// kind in {dense,sparse}
bool parse_config(const char* config, std::vector<Slot>* out) {
  std::string cfg(config ? config : "");
  size_t pos = 0;
  while (pos < cfg.size()) {
    size_t semi = cfg.find(';', pos);
    std::string part = cfg.substr(
        pos, semi == std::string::npos ? std::string::npos : semi - pos);
    pos = semi == std::string::npos ? cfg.size() : semi + 1;
    if (part.empty()) continue;
    Slot s;
    std::vector<std::string> f;
    size_t q = 0;
    while (q <= part.size()) {
      size_t c = part.find(':', q);
      f.push_back(part.substr(
          q, c == std::string::npos ? std::string::npos : c - q));
      if (c == std::string::npos) break;
      q = c + 1;
    }
    if (f.size() < 3) return false;
    s.name = f[0];
    if (f[1] == "float") s.is_float = true;
    else if (f[1] == "int64") s.is_float = false;
    else return false;
    if (f[2] == "dense") s.dense = true;
    else if (f[2] == "sparse") s.dense = false;
    else return false;
    s.dim = 1;
    if (f.size() > 3) {
      s.dim = std::atoi(f[3].c_str());
      if (s.dim <= 0) return false;
    }
    out->push_back(s);
  }
  return !out->empty();
}

}  // namespace

extern "C" {

void* df_open(const char* config, const char** files, int nfiles,
              int nthreads, int batch_size, int queue_cap) {
  if (nfiles <= 0 || batch_size <= 0) return nullptr;
  auto feed = std::make_unique<Feed>();
  if (!parse_config(config, &feed->slots)) return nullptr;
  for (int i = 0; i < nfiles; ++i) feed->files.emplace_back(files[i]);
  feed->batch_size = batch_size;
  feed->queue_cap = queue_cap > 0 ? queue_cap : 8;
  if (nthreads < 1) nthreads = 1;
  if (static_cast<size_t>(nthreads) > feed->files.size())
    nthreads = static_cast<int>(feed->files.size());
  feed->active_workers = nthreads;
  Feed* f = feed.get();
  for (int i = 0; i < nthreads; ++i)
    f->workers.emplace_back([f] { f->worker(); });
  return feed.release();
}

// Returns a batch pointer, or nullptr at end-of-data / error / closed.
void* df_next(void* h) {
  Feed* f = static_cast<Feed*>(h);
  if (!f) return nullptr;
  std::unique_lock<std::mutex> l(f->mu);
  f->cv_pop.wait(l, [&] {
    return !f->ready.empty() || f->active_workers == 0 || f->stop.load();
  });
  if (f->ready.empty() || f->stop.load()) return nullptr;
  SlotBatch* b = f->ready.front();
  f->ready.pop();
  f->cv_push.notify_one();
  return b;
}

int df_batch_rows(void* b) {
  return b ? static_cast<SlotBatch*>(b)->rows : 0;
}

// Value array for slot s: *out -> float or int64 data; returns count.
int64_t df_values(void* h, void* b, int s, const void** out) {
  Feed* f = static_cast<Feed*>(h);
  SlotBatch* sb = static_cast<SlotBatch*>(b);
  if (!f || !sb || s < 0 || static_cast<size_t>(s) >= f->slots.size())
    return -1;
  if (f->slots[s].is_float) {
    *out = sb->fvals[s].data();
    return static_cast<int64_t>(sb->fvals[s].size());
  }
  *out = sb->ivals[s].data();
  return static_cast<int64_t>(sb->ivals[s].size());
}

// Row-offset table for slot s (rows+1 entries); returns entry count.
int64_t df_lod(void* h, void* b, int s, const int64_t** out) {
  Feed* f = static_cast<Feed*>(h);
  SlotBatch* sb = static_cast<SlotBatch*>(b);
  if (!f || !sb || s < 0 || static_cast<size_t>(s) >= f->slots.size())
    return -1;
  *out = sb->offsets[s].data();
  return static_cast<int64_t>(sb->offsets[s].size());
}

void df_batch_free(void* b) { delete static_cast<SlotBatch*>(b); }

const char* df_error(void* h) {
  Feed* f = static_cast<Feed*>(h);
  if (!f) return "";
  std::lock_guard<std::mutex> l(f->mu);
  // pointer stays valid: error is set once and never mutated after
  return f->error.c_str();
}

void df_close(void* h) { delete static_cast<Feed*>(h); }

}  // extern "C"
