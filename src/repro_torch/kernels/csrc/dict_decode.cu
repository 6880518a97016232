// Dictionary decode: out[i] = dictionary[codes[i]].
//
// Replaces the TPU kernel src/repro/kernels/dict_decode/dict_decode.py
// (dict_decode, through ops.py::decode_dictionary).  That kernel computed
// in float32, by a one-hot matrix product for small dictionaries: integers
// had to stay below 2**24, and one NaN or inf in the dictionary poisoned
// every output of its tile.  Here each element is copied as raw bits
// (4- or 8-byte words), so every dtype, NaN payload, -0.0 and int64 value
// comes back exactly.
//
// Bound on the H100: bytes.  The call must read 4N bytes of codes and D*s
// of dictionary and write N*s, with no arithmetic to speak of, so its
// floor is (4N + D*s + N*s) / 3.35 TB/s.  Design: a grid-stride loop with
// neighbouring threads on neighbouring codes (coalesced reads and writes);
// the dictionary is staged once per block in shared memory when D*s fits
// in 48 KB, so the random reads of the gather hit shared memory, and is
// read through the read-only path (L2) when it does not.  A code outside
// [0, D) sets an error flag in device memory that the wrapper reads.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kSmemBytes = 48 * 1024;

template <typename T, bool kStaged>
__global__ void dict_decode_kernel(const int32_t* __restrict__ codes,
                                   const T* __restrict__ dict,
                                   T* __restrict__ out,
                                   int32_t* __restrict__ err, long long n,
                                   int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sdict = reinterpret_cast<T*>(smem);
  if (kStaged) {
    for (int j = threadIdx.x; j < d; j += blockDim.x) sdict[j] = dict[j];
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const int32_t c = codes[i];
    if ((uint32_t)c < (uint32_t)d) {
      out[i] = kStaged ? sdict[c] : __ldg(dict + c);
    } else {
      *err = 1;
    }
  }
}

template <typename T>
cudaError_t launch(const void* codes, const void* dict, void* out, void* err,
                   long long n, long long d, cudaStream_t stream) {
  const int grid = grid_for(n, kThreads);
  const auto* c = static_cast<const int32_t*>(codes);
  const auto* dic = static_cast<const T*>(dict);
  auto* o = static_cast<T*>(out);
  auto* e = static_cast<int32_t*>(err);
  const long long bytes = d * (long long)sizeof(T);
  if (bytes <= kSmemBytes) {
    dict_decode_kernel<T, true><<<grid, kThreads, bytes, stream>>>(
        c, dic, o, e, n, (int)d);
  } else {
    dict_decode_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        c, dic, o, e, n, (int)d);
  }
  return cudaGetLastError();
}

}  // namespace

// codes: int32[n]; dict: elem_size-byte words [d]; out: [n]; err: int32[1]
// (zeroed by the caller).  d must be below 2**31.
extern "C" int dict_decode_launch(const void* codes, const void* dict,
                                  void* out, void* err, long long n,
                                  long long d, int elem_size, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (elem_size) {
    case 4:
      return (int)launch<unsigned int>(codes, dict, out, err, n, d, s);
    case 8:
      return (int)launch<unsigned long long>(codes, dict, out, err, n, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
