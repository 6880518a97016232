// Fused predicate: one uint8 mask from a flat AND/OR of column-vs-constant
// comparisons, optionally negated, in one pass over the columns.
//
// Replaces the TPU kernel
// src/repro/kernels/predicate_fused/predicate_fused.py (predicate_mask,
// through ops.py::fused_predicate).  That kernel read a (C, N) float32
// stack that ops._stack built by copying and casting every column, so
// int64 and float64 columns, and constants off the float32 grid, could not
// be compared exactly.  Here the columns are read in place, each in its
// own dtype, and each term compares in the type NumPy would use for
// `column OP constant` (the wrapper computes it on the host), so the mask
// equals the host evaluation bit for bit: NaN gives false for every
// operator but !=.
//
// Bound on the H100: bytes.  Per row it reads each referenced column once
// and writes one byte, so its floor is (sum_c N*itemsize_c + N) /
// 3.35 TB/s; a few compares per row are far below the card's integer and
// float rates.  Design: a grid-stride loop, one row per thread per step,
// neighbouring threads on neighbouring rows; the program (at most 8
// columns, 16 terms) is passed by value as a __grid_constant__ parameter,
// so the per-row term loop reads it from the constant bank with no copy.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 8;
constexpr int kMaxTerms = 16;

// dtype and compare-type codes, shared with the Python wrapper
enum { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3 };
// operator codes: lt le gt ge eq ne
enum { kLt = 0, kLe = 1, kGt = 2, kGe = 3, kEq = 4, kNe = 5 };

struct Term {
  int col;
  int op;
  int ctype;
  double fvalue;       // the constant, exact in the compare type (floats)
  long long ivalue;    // the constant (integer compare types)
};

struct Program {
  const void* cols[kMaxCols];
  int dtypes[kMaxCols];
  Term terms[kMaxTerms];
  int nterms;
  int combine_or;
  int negate;
};

template <typename T>
__device__ __forceinline__ T load_as(const void* p, int dtype, long long i) {
  switch (dtype) {
    case kI32: return static_cast<T>(static_cast<const int32_t*>(p)[i]);
    case kI64: return static_cast<T>(static_cast<const long long*>(p)[i]);
    case kF32: return static_cast<T>(static_cast<const float*>(p)[i]);
    default: return static_cast<T>(static_cast<const double*>(p)[i]);
  }
}

template <typename T>
__device__ __forceinline__ bool compare(T x, T v, int op) {
  switch (op) {
    case kLt: return x < v;
    case kLe: return x <= v;
    case kGt: return x > v;
    case kGe: return x >= v;
    case kEq: return x == v;
    default: return x != v;
  }
}

__global__ void predicate_fused_kernel(const __grid_constant__ Program prog,
                                       uint8_t* __restrict__ out,
                                       long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    bool acc = !prog.combine_or;
    for (int t = 0; t < prog.nterms; ++t) {
      const Term& term = prog.terms[t];
      const void* col = prog.cols[term.col];
      const int dtype = prog.dtypes[term.col];
      bool m;
      switch (term.ctype) {
        case kI32:
          m = compare(load_as<int32_t>(col, dtype, i),
                      static_cast<int32_t>(term.ivalue), term.op);
          break;
        case kI64:
          m = compare(load_as<long long>(col, dtype, i), term.ivalue,
                      term.op);
          break;
        case kF32:
          m = compare(load_as<float>(col, dtype, i),
                      static_cast<float>(term.fvalue), term.op);
          break;
        default:
          m = compare(load_as<double>(col, dtype, i), term.fvalue, term.op);
      }
      acc = prog.combine_or ? (acc || m) : (acc && m);
    }
    out[i] = static_cast<uint8_t>(prog.negate ? !acc : acc);
  }
}

}  // namespace

// cols/dtypes: ncols column pointers and dtype codes (host arrays);
// term_col/term_op/term_ctype/term_f/term_i: nterms terms (host arrays);
// out: uint8[n].
extern "C" int predicate_fused_launch(
    const void* const* cols, const int* dtypes, int ncols,
    const int* term_col, const int* term_op, const int* term_ctype,
    const double* term_f, const long long* term_i, int nterms,
    int combine_or, int negate, void* out, long long n, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || nterms < 1 || nterms > kMaxTerms)
    return (int)cudaErrorInvalidValue;
  Program prog = {};
  for (int c = 0; c < ncols; ++c) {
    prog.cols[c] = cols[c];
    prog.dtypes[c] = dtypes[c];
  }
  for (int t = 0; t < nterms; ++t) {
    if (term_col[t] < 0 || term_col[t] >= ncols)
      return (int)cudaErrorInvalidValue;
    prog.terms[t] = Term{term_col[t], term_op[t], term_ctype[t], term_f[t],
                         term_i[t]};
  }
  prog.nterms = nterms;
  prog.combine_or = combine_or;
  prog.negate = negate;
  const int grid = grid_for(n, kThreads);
  predicate_fused_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      prog, static_cast<uint8_t*>(out), n);
  return (int)cudaGetLastError();
}
