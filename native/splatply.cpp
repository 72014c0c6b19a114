// splatply: native binary-PLY vertex-blob codec for the data-loading path.
//
// The native analog of the reference's C++ PLY layer (ref: src/ply.cpp):
// the Python side parses the (tiny) header, then delegates the hot part —
// de-interleaving the vertex blob into column-major float32 arrays and the
// inverse re-interleave on export — to this library via ctypes. For the
// multi-hundred-MB .ply files real scenes use (1.5M splats x 248 B), the
// strided gather in (multi-threaded) C++ keeps scene loading off the Python
// interpreter's critical path.
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC -pthread).

#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

struct Column {
  int32_t src_offset;  // byte offset of the property inside a vertex record
  int32_t type;        // 0=f32, 1=f64, 2=u8, 3=i32 (source dtype in the blob)
};

inline float read_as_float(const uint8_t* p, int32_t type) {
  switch (type) {
    case 0: { float v; std::memcpy(&v, p, 4); return v; }
    case 1: { double v; std::memcpy(&v, p, 8); return static_cast<float>(v); }
    case 2: return static_cast<float>(*p);
    case 3: { int32_t v; std::memcpy(&v, p, 4); return static_cast<float>(v); }
  }
  return 0.0f;
}

inline void write_from_float(uint8_t* p, int32_t type, float v) {
  switch (type) {
    case 0: std::memcpy(p, &v, 4); break;
    case 1: { double d = v; std::memcpy(p, &d, 8); break; }
    case 2: { *p = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v + 0.5f)); break; }
    case 3: { int32_t i = static_cast<int32_t>(v); std::memcpy(p, &i, 4); break; }
  }
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t num_threads = hw ? static_cast<int64_t>(hw) : 4;
  if (n < 1 << 16) num_threads = 1;
  if (num_threads > n) num_threads = n ? n : 1;
  std::vector<std::thread> threads;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// De-interleave: blob of n records (stride bytes each) -> out[n, num_cols]
// float32 row-major, one column per requested property.
void splatply_decode(const uint8_t* blob, int64_t n, int32_t stride,
                     const Column* cols, int32_t num_cols, float* out) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const uint8_t* rec = blob + i * stride;
      float* dst = out + i * num_cols;
      for (int32_t c = 0; c < num_cols; ++c) {
        dst[c] = read_as_float(rec + cols[c].src_offset, cols[c].type);
      }
    }
  });
}

// Re-interleave: values[n, num_cols] float32 -> blob records (stride bytes).
// Bytes not covered by any column are left untouched (caller zero-fills).
void splatply_encode(const float* values, int64_t n, int32_t stride,
                     const Column* cols, int32_t num_cols, uint8_t* blob) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* src = values + i * num_cols;
      uint8_t* rec = blob + i * stride;
      for (int32_t c = 0; c < num_cols; ++c) {
        write_from_float(rec + cols[c].src_offset, cols[c].type, src[c]);
      }
    }
  });
}

int32_t splatply_version() { return 1; }

}  // extern "C"
