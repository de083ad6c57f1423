// Asynchronous classic-NetCDF (CDF-2 / 64-bit-offset) writer.
//
// A copy of csrc/ncwriter.cpp for icar_tpu_torch, which builds it into its
// own icar_tpu_torch/_build/ (io/async_writer.py). Model output snapshots
// are handed to a background worker thread which serializes them to NetCDF
// classic files off the critical path, so device steps never wait on disk
// — the role the reference's per-image NetCDF output layer plays
// (src/io/output_obj.f90 of the reference), rebuilt as host-side C++.
//
// Scope: float32 variables with named dimensions, global/variable text
// attributes, one file per call (no record dimension growth; the driver
// writes one file per output step or one consolidated file at the end).
// Files are readable by any NetCDF implementation (validated against
// scipy.io.netcdf_file).
//
// Build (io/async_writer.py does it at first use):
//   g++ -O2 -fPIC -shared -std=c++17 -pthread ncwriter.cpp -o libncwriter.so

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CDF serialization helpers (big-endian)
// ---------------------------------------------------------------------------

struct Buf {
  std::vector<unsigned char> b;
  void u8(uint8_t v) { b.push_back(v); }
  void u32(uint32_t v) {
    b.push_back(v >> 24); b.push_back(v >> 16); b.push_back(v >> 8); b.push_back(v);
  }
  void u64(uint64_t v) { u32(v >> 32); u32((uint32_t)v); }
  void f32(float v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    u32(u);
  }
  void name(const std::string& s) {
    u32((uint32_t)s.size());
    for (char c : s) u8((uint8_t)c);
    while (b.size() % 4) u8(0);  // pad to 4-byte boundary
  }
};

constexpr uint32_t NC_DIMENSION = 0x0A;
constexpr uint32_t NC_VARIABLE = 0x0B;
constexpr uint32_t NC_ATTRIBUTE = 0x0C;
constexpr uint32_t NC_CHAR = 2;
constexpr uint32_t NC_FLOAT = 5;
constexpr uint32_t NC_ABSENT = 0;

struct Var {
  std::string name;
  std::vector<int> dimids;
  std::vector<std::pair<std::string, std::string>> atts;
  std::vector<float> data;
  uint64_t begin = 0;
};

struct FileJob {
  std::string path;
  std::vector<std::pair<std::string, uint32_t>> dims;  // name, size
  std::vector<std::pair<std::string, std::string>> gatts;
  std::vector<Var> vars;
};

void write_atts(Buf& h, const std::vector<std::pair<std::string, std::string>>& atts) {
  if (atts.empty()) {
    h.u32(NC_ABSENT);
    h.u32(0);
    return;
  }
  h.u32(NC_ATTRIBUTE);
  h.u32((uint32_t)atts.size());
  for (auto& [k, v] : atts) {
    h.name(k);
    h.u32(NC_CHAR);
    h.u32((uint32_t)v.size());
    for (char c : v) h.u8((uint8_t)c);
    while (h.b.size() % 4) h.u8(0);
  }
}

bool write_cdf(FileJob& job) {
  // header sizing needs two passes because 'begin' offsets depend on the
  // header length: build the header once with dummy offsets, then rebuild.
  uint64_t header_size = 0;
  for (int pass = 0; pass < 2; ++pass) {
    Buf h;
    h.u8('C'); h.u8('D'); h.u8('F'); h.u8(2);  // CDF-2: 64-bit offsets
    h.u32(0);                                  // numrecs
    if (job.dims.empty()) { h.u32(NC_ABSENT); h.u32(0); }
    else {
      h.u32(NC_DIMENSION);
      h.u32((uint32_t)job.dims.size());
      for (auto& [n, s] : job.dims) { h.name(n); h.u32(s); }
    }
    write_atts(h, job.gatts);
    if (job.vars.empty()) { h.u32(NC_ABSENT); h.u32(0); }
    else {
      h.u32(NC_VARIABLE);
      h.u32((uint32_t)job.vars.size());
      for (auto& v : job.vars) {
        h.name(v.name);
        h.u32((uint32_t)v.dimids.size());
        for (int d : v.dimids) h.u32((uint32_t)d);
        write_atts(h, v.atts);
        h.u32(NC_FLOAT);
        uint64_t vsize = (uint64_t)v.data.size() * 4;
        vsize = (vsize + 3) & ~3ull;
        h.u32((uint32_t)std::min<uint64_t>(vsize, 0xFFFFFFFFull));
        h.u64(v.begin);
      }
    }
    if (pass == 0) {
      header_size = h.b.size();
      uint64_t off = header_size;
      for (auto& v : job.vars) {
        v.begin = off;
        uint64_t vsize = (uint64_t)v.data.size() * 4;
        off += (vsize + 3) & ~3ull;
      }
    } else {
      FILE* f = std::fopen(job.path.c_str(), "wb");
      if (!f) return false;
      std::fwrite(h.b.data(), 1, h.b.size(), f);
      std::vector<unsigned char> be;
      for (auto& v : job.vars) {
        be.resize(v.data.size() * 4);
        for (size_t i = 0; i < v.data.size(); ++i) {
          uint32_t u;
          std::memcpy(&u, &v.data[i], 4);
          be[4 * i] = u >> 24; be[4 * i + 1] = u >> 16;
          be[4 * i + 2] = u >> 8; be[4 * i + 3] = (unsigned char)u;
        }
        std::fwrite(be.data(), 1, be.size(), f);
      }
      std::fclose(f);
    }
  }
  return true;
}

// ---------------------------------------------------------------------------
// background worker
// ---------------------------------------------------------------------------

struct Writer {
  std::thread worker;
  std::mutex m;
  std::condition_variable cv;
  std::queue<FileJob> q;
  bool stop = false;
  bool busy = false;
  int errors = 0;
  int written = 0;

  Writer() {
    worker = std::thread([this] {
      for (;;) {
        FileJob job;
        {
          std::unique_lock<std::mutex> lk(m);
          cv.wait(lk, [this] { return stop || !q.empty(); });
          if (q.empty()) {
            if (stop) return;
            continue;
          }
          job = std::move(q.front());
          q.pop();
          busy = true;
        }
        bool ok = write_cdf(job);
        {
          std::lock_guard<std::mutex> lk(m);
          busy = false;
          if (ok) ++written; else ++errors;
          cv.notify_all();
        }
      }
    });
  }
};

}  // namespace

extern "C" {

void* ncw_start() { return new Writer(); }

// Enqueue one file. Layout of the arguments:
//   dims: n_dims names + sizes define the file's dimension table
//   vars: per-var name, ndims, dim indices (into the table), data pointer
// Data is COPIED before returning, so callers may free immediately.
void ncw_write_file(void* ctx, const char* path,
                    int n_dims, const char** dim_names, const int* dim_sizes,
                    int n_gatts, const char** gatt_names, const char** gatt_vals,
                    int n_vars, const char** var_names, const int* var_ndims,
                    const int* var_dimids,   // concatenated
                    const float** var_data) {
  auto* w = static_cast<Writer*>(ctx);
  FileJob job;
  job.path = path;
  for (int i = 0; i < n_dims; ++i)
    job.dims.emplace_back(dim_names[i], (uint32_t)dim_sizes[i]);
  for (int i = 0; i < n_gatts; ++i)
    job.gatts.emplace_back(gatt_names[i], gatt_vals[i]);
  int pos = 0;
  for (int i = 0; i < n_vars; ++i) {
    Var v;
    v.name = var_names[i];
    uint64_t n = 1;
    for (int d = 0; d < var_ndims[i]; ++d) {
      int id = var_dimids[pos++];
      v.dimids.push_back(id);
      n *= job.dims[id].second;
    }
    v.data.assign(var_data[i], var_data[i] + n);
    job.vars.push_back(std::move(v));
  }
  {
    std::lock_guard<std::mutex> lk(w->m);
    w->q.push(std::move(job));
  }
  w->cv.notify_all();
}

// Block until the queue drains (including any in-flight write).
// Returns the number of failed writes so far.
int ncw_wait(void* ctx) {
  auto* w = static_cast<Writer*>(ctx);
  std::unique_lock<std::mutex> lk(w->m);
  w->cv.wait(lk, [w] { return w->q.empty() && !w->busy; });
  return w->errors;
}

int ncw_files_written(void* ctx) {
  auto* w = static_cast<Writer*>(ctx);
  std::lock_guard<std::mutex> lk(w->m);
  return w->written;
}

void ncw_stop(void* ctx) {
  auto* w = static_cast<Writer*>(ctx);
  {
    std::lock_guard<std::mutex> lk(w->m);
    w->stop = true;
  }
  w->cv.notify_all();
  w->worker.join();
  delete w;
}

}  // extern "C"
