// Native ingest runtime for bioem_tpu_torch.
//
// C++ equivalent of the reference's OpenMP-parallel readers
// (reference map.cpp:85-193,268-414, model.cpp:114-243,
// include/mrc.h:72-237 — READ_PARALLEL, defs.h:54): multi-threaded parsing
// of particle-image stacks (MRC + PARTICLE text) and point-cloud models,
// exposed through a small C ABI consumed via ctypes from
// bioem_tpu_torch/runtime/native.py. Semantics match the port's NumPy
// readers in bioem_tpu_torch/io exactly (they are cross-checked bit for bit
// in tests/test_torch_native_io.py); this path exists for throughput on
// ~50k-image production stacks. The port keeps its own copy of the JAX
// package's source so that neither package builds into the other's tree.
//
// Build: bioem_tpu_torch/runtime/native.py (g++ -O3 -shared -fPIC -pthread,
// into bioem_tpu_torch/_build/, keyed by a hash of this file and the flags).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kErrLen = 512;

void set_err(char* err, const std::string& msg) {
  if (err) {
    std::snprintf(err, kErrLen, "%s", msg.c_str());
  }
}

int hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// Run fn(t) on nthreads threads.
template <typename Fn>
void parallel_for_threads(int nthreads, Fn fn) {
  std::vector<std::thread> ts;
  ts.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) ts.emplace_back(fn, t);
  for (auto& th : ts) th.join();
}

// Read a whole file into a string. Returns false on failure.
bool slurp(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long sz = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (sz < 0) {
    std::fclose(f);
    return false;
  }
  out->resize(static_cast<size_t>(sz));
  size_t got = sz ? std::fread(&(*out)[0], 1, static_cast<size_t>(sz), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(sz);
}

inline uint32_t bswap32(uint32_t v) {
  return ((v & 0xff000000u) >> 24) | ((v & 0x00ff0000u) >> 8) |
         ((v & 0x0000ff00u) << 8) | ((v & 0x000000ffu) << 24);
}

inline int32_t load_i32(const unsigned char* p, bool swap) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  if (swap) v = bswap32(v);
  int32_t out;
  std::memcpy(&out, &v, 4);
  return out;
}

inline float load_f32(const unsigned char* p, bool swap) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  if (swap) v = bswap32(v);
  float out;
  std::memcpy(&out, &v, 4);
  return out;
}

// Header-sanity endianness vote (reference mrc.h:72-149 behaviour).
int range_violations(const unsigned char* raw, bool swap) {
  int32_t ints[10];
  for (int k = 0; k < 10; ++k) ints[k] = load_i32(raw + 4 * k, swap);
  float alpha = load_f32(raw + 52, swap);
  float beta = load_f32(raw + 56, swap);
  float gamma = load_f32(raw + 60, swap);
  int v = 0;
  const int dims[6] = {0, 1, 2, 7, 8, 9};   // nc nr ns mx my mz
  const int cells[3] = {4, 5, 6};           // ncstart nrstart nsstart
  for (int k : dims) v += (ints[k] > 5000) + (ints[k] < 0);
  for (int k : cells) v += (ints[k] > 5000) + (ints[k] < -5000);
  for (float a : {alpha, beta, gamma}) v += (a > 360.0f) + (a < -360.0f);
  return v;
}

// Zero-mean / unit population-σ normalisation, matching
// bioem_tpu_torch/io/map_io.py::_normalize_stack bit-for-bit: stats in double,
// then float32 `x / sig_f - off_f`.
void normalize_images(float* maps, long n_img, long npix2, int nthreads) {
  parallel_for_threads(nthreads, [&](int t) {
    for (long i = t; i < n_img; i += nthreads) {
      float* m = maps + i * npix2;
      double s = 0.0, s2 = 0.0;
      for (long k = 0; k < npix2; ++k) {
        s += m[k];
        s2 += static_cast<double>(m[k]) * m[k];
      }
      double mean = s / npix2;
      double sig = std::sqrt(s2 / npix2 - mean * mean);
      float sig_f = static_cast<float>(sig);
      float off_f = static_cast<float>(mean / sig);
      for (long k = 0; k < npix2; ++k) m[k] = m[k] / sig_f - off_f;
    }
  });
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// MRC particle stack
// ---------------------------------------------------------------------------

// Parse header; returns 0 on success and fills n_img (= ns).
int bio_mrc_stack_info(const char* path, int n_pixels, int* n_img, char* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_err(err, std::string("Opening MRC: ") + path);
    return 1;
  }
  unsigned char raw[1024];
  if (std::fread(raw, 1, 1024, f) != 1024) {
    std::fclose(f);
    set_err(err, std::string("Reading MRC header: ") + path);
    return 1;
  }
  std::fclose(f);
  int v_le = range_violations(raw, false);
  int v_be = range_violations(raw, true);
  bool swap = !(v_le < v_be);
  int32_t nc = load_i32(raw + 0, swap);
  int32_t nr = load_i32(raw + 4, swap);
  int32_t ns = load_i32(raw + 8, swap);
  int32_t mode = load_i32(raw + 12, swap);
  if (mode != 2) {
    set_err(err, "MRC mode: " + std::to_string(mode) +
                     ". Currently mode 2 is the only one allowed");
    return 1;
  }
  if (nr != n_pixels || nc != n_pixels) {
    set_err(err, "Inconsistent number of pixels in maps and inputfile (" +
                     std::to_string(n_pixels) + ", i " + std::to_string(nc) +
                     ", j " + std::to_string(nr) + ")");
    return 1;
  }
  *n_img = ns;
  return 0;
}

// Read the stack into caller-allocated out[(n_img, N, N)] float32 with the
// reference's transposed layout maps[i, j] = file[j, i]
// (map.cpp:663-853) and optional per-image normalisation.
int bio_read_mrc_stack(const char* path, int n_pixels, int normalize,
                       float* out, int n_img, char* err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    set_err(err, std::string("Opening MRC: ") + path);
    return 1;
  }
  unsigned char raw[1024];
  if (std::fread(raw, 1, 1024, f) != 1024) {
    std::fclose(f);
    set_err(err, std::string("Reading MRC header: ") + path);
    return 1;
  }
  int v_le = range_violations(raw, false);
  int v_be = range_violations(raw, true);
  bool swap = !(v_le < v_be);
  int32_t nsymbt = load_i32(raw + 92, swap);
  if (std::fseek(f, 1024 + nsymbt, SEEK_SET) != 0) {
    std::fclose(f);
    set_err(err, std::string("Seeking MRC data: ") + path);
    return 1;
  }
  const long n = n_pixels;
  const long npix2 = n * n;
  const long count = static_cast<long>(n_img) * npix2;
  std::vector<float> filebuf(count);
  if (std::fread(filebuf.data(), 4, count, f) != static_cast<size_t>(count)) {
    std::fclose(f);
    set_err(err, std::string("Converting Data: ") + path);
    return 1;
  }
  std::fclose(f);

  int nthreads = hw_threads();
  parallel_for_threads(nthreads, [&](int t) {
    for (long img = t; img < n_img; img += nthreads) {
      const float* src = filebuf.data() + img * npix2;
      float* dst = out + img * npix2;
      if (swap) {
        for (long j = 0; j < n; ++j)
          for (long i = 0; i < n; ++i) {
            uint32_t v;
            std::memcpy(&v, src + j * n + i, 4);
            v = bswap32(v);
            std::memcpy(dst + i * n + j, &v, 4);
          }
      } else {
        for (long j = 0; j < n; ++j)
          for (long i = 0; i < n; ++i) dst[i * n + j] = src[j * n + i];
      }
    }
  });
  if (normalize) normalize_images(out, n_img, npix2, nthreads);
  return 0;
}

// ---------------------------------------------------------------------------
// PARTICLE-separated text maps (reference map.cpp:268-518, %8d%8d%16.8f)
// ---------------------------------------------------------------------------

int bio_text_maps_info(const char* path, int* n_img, char* err) {
  std::string buf;
  if (!slurp(path, &buf)) {
    set_err(err, std::string("Opening particle file: ") + path);
    return 1;
  }
  if (buf.rfind("PARTICLE", 0) != 0) {
    set_err(err, "Missing correct standard map format: PARTICLE HEADER");
    return 1;
  }
  int cnt = 0;
  size_t pos = 0;
  while ((pos = buf.find("PARTICLE", pos)) != std::string::npos) {
    ++cnt;
    pos += 8;
  }
  *n_img = cnt;
  return 0;
}

int bio_read_text_maps(const char* path, int n_pixels, float* out, int n_img,
                       char* err) {
  std::string buf;
  if (!slurp(path, &buf)) {
    set_err(err, std::string("Opening particle file: ") + path);
    return 1;
  }
  // Locate block starts (the character after each PARTICLE header line).
  std::vector<size_t> starts;
  starts.reserve(n_img + 1);
  size_t pos = 0;
  while ((pos = buf.find("PARTICLE", pos)) != std::string::npos) {
    size_t nl = buf.find('\n', pos);
    starts.push_back(nl == std::string::npos ? buf.size() : nl + 1);
    pos += 8;
  }
  if (static_cast<int>(starts.size()) != n_img) {
    set_err(err, "Particle count changed between info and read");
    return 1;
  }
  starts.push_back(buf.size() + 8);  // sentinel; block b ends at next PARTICLE

  // End of block b = position of PARTICLE b+1 minus header; recompute ends.
  std::vector<size_t> ends(n_img);
  pos = 0;
  int b = 0;
  while ((pos = buf.find("PARTICLE", pos)) != std::string::npos) {
    if (b > 0) ends[b - 1] = pos;
    ++b;
    pos += 8;
  }
  ends[n_img - 1] = buf.size();

  const long npix2 = static_cast<long>(n_pixels) * n_pixels;
  std::vector<std::string> errors(n_img);
  int nthreads = hw_threads();
  parallel_for_threads(nthreads, [&](int t) {
    for (int img = t; img < n_img; img += nthreads) {
      const char* p = buf.data() + starts[img];
      const char* end = buf.data() + ends[img];
      float* m = out + img * npix2;
      std::memset(m, 0, npix2 * sizeof(float));
      long rows = 0;
      while (p < end) {
        const char* nl = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        size_t len = nl ? static_cast<size_t>(nl - p)
                        : static_cast<size_t>(end - p);
        // skip blank lines
        bool blank = true;
        for (size_t k = 0; k < len; ++k)
          if (!std::isspace(static_cast<unsigned char>(p[k]))) {
            blank = false;
            break;
          }
        if (!blank) {
          if (len < 17) {
            errors[img] = "Reading map (Map number " + std::to_string(img) + ")";
            return;
          }
          char tmp[17];
          std::memcpy(tmp, p, 8);
          tmp[8] = 0;
          long i = std::strtol(tmp, nullptr, 10);
          std::memcpy(tmp, p + 8, 8);
          tmp[8] = 0;
          long j = std::strtol(tmp, nullptr, 10);
          size_t flen = len - 16 < 16 ? len - 16 : 16;
          std::memcpy(tmp, p + 16, flen);
          tmp[flen] = 0;
          double v = std::strtod(tmp, nullptr);
          if (i < 0 || i >= n_pixels || j < 0 || j >= n_pixels) {
            errors[img] = "Reading map (Map number " + std::to_string(img) + ")";
            return;
          }
          m[i * n_pixels + j] = static_cast<float>(v);
          ++rows;
        }
        if (!nl) break;
        p = nl + 1;
      }
      if (rows != npix2) {
        errors[img] = "Inconsistent number of pixels in maps and inputfile (" +
                      std::to_string(rows) + ", map " + std::to_string(img) +
                      ")";
      }
    }
  });
  for (int i = 0; i < n_img; ++i) {
    if (!errors[i].empty()) {
      set_err(err, errors[i]);
      return 1;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Whitespace text model: x y z radius density (reference model.cpp:419-601)
// ---------------------------------------------------------------------------

int bio_text_model_info(const char* path, long* n_points, char* err) {
  std::string buf;
  if (!slurp(path, &buf)) {
    set_err(err, std::string("Opening model file: ") + path);
    return 1;
  }
  long cnt = 0;
  size_t p = 0;
  while (p < buf.size()) {
    size_t nl = buf.find('\n', p);
    if (nl == std::string::npos) nl = buf.size();
    for (size_t k = p; k < nl; ++k)
      if (!std::isspace(static_cast<unsigned char>(buf[k]))) {
        if (buf[k] != '#') ++cnt;
        break;
      }
    p = nl + 1;
  }
  *n_points = cnt;
  return 0;
}

// Fill out[(n_points, 5)] float64 rows (x y z radius density).
int bio_read_text_model(const char* path, double* out, long n_points,
                        char* err) {
  std::string buf;
  if (!slurp(path, &buf)) {
    set_err(err, std::string("Opening model file: ") + path);
    return 1;
  }
  // Collect non-comment line offsets, then parse in parallel.
  std::vector<std::pair<size_t, size_t>> lines;
  lines.reserve(n_points);
  size_t p = 0;
  while (p < buf.size()) {
    size_t nl = buf.find('\n', p);
    if (nl == std::string::npos) nl = buf.size();
    for (size_t k = p; k < nl; ++k)
      if (!std::isspace(static_cast<unsigned char>(buf[k]))) {
        if (buf[k] != '#') lines.emplace_back(p, nl);
        break;
      }
    p = nl + 1;
  }
  if (static_cast<long>(lines.size()) != n_points) {
    set_err(err, "Model line count changed between info and read");
    return 1;
  }
  std::vector<std::string> errors(hw_threads());
  int nthreads = hw_threads();
  parallel_for_threads(nthreads, [&](int t) {
    for (long r = t; r < n_points; r += nthreads) {
      std::string line = buf.substr(lines[r].first,
                                    lines[r].second - lines[r].first);
      const char* q = line.c_str();
      char* qe;
      for (int c = 0; c < 5; ++c) {
        double v = std::strtod(q, &qe);
        if (qe == q) {
          errors[t] = "Model file needs 5 columns: x y z radius density";
          return;
        }
        out[r * 5 + c] = v;
        q = qe;
      }
    }
  });
  for (auto& e : errors)
    if (!e.empty()) {
      set_err(err, e);
      return 1;
    }
  return 0;
}

}  // extern "C"
