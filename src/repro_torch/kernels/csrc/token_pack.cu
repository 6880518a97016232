// Order-preserving stream compaction: out[k] = values[i_k], where i_0 <
// i_1 < ... are the rows whose mask byte is nonzero.
//
// Replaces the TPU kernel src/repro/kernels/token_pack/token_pack.py
// (tile_pack, through ops.py::pack_tokens).  That kernel compacted each
// 512-row tile by a (512 x 512) one-hot matrix product in float32, so
// integers had to stay below 2**24 and one NaN or inf poisoned its tile.
// Here selected elements are copied as raw bits (1-, 4- or 8-byte words).
//
// Bound on the H100: bytes.  Compacting one column reads the mask (N
// bytes) and the values (N*s) and writes count*s, so its floor is
// (N + N*s + count*s) / 3.35 TB/s.  Design: two kernels.  The first
// counts the selected rows of each 1024-row block (a warp __ballot_sync
// and __popc per warp, summed in shared memory); the block offsets are an
// exclusive cumsum of those counts, taken once per mask in the wrapper
// and reused for every column of the row group.  The second recomputes
// each selected row's rank inside its block the same way and writes the
// value to offset + rank.  Both read the mask coalesced, one byte per
// thread; the reads of the values are coalesced and the writes nearly so.

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBlock = 1024;   // rows per block = threads per block
constexpr int kWarps = kBlock / 32;

// Selected rows of this block before each warp (exclusive), in shared
// memory, plus this thread's ballot.  Returns the block's total.
__device__ __forceinline__ int block_ranks(bool m, int* warp_prefix,
                                           unsigned* ballot) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  *ballot = __ballot_sync(0xffffffffu, m);
  if (lane == 0) warp_prefix[warp] = __popc(*ballot);
  __syncthreads();
  int total = 0;
  if (warp == 0) {
    const int own = warp_prefix[lane];
    int inc = own;
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += up;
    }
    warp_prefix[lane] = inc - own;
    total = __shfl_sync(0xffffffffu, inc, 31);
  }
  __syncthreads();
  return total;
}

__global__ void count_kernel(const uint8_t* __restrict__ mask,
                             int32_t* __restrict__ counts, long long n) {
  __shared__ int warp_prefix[kWarps];
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool m = i < n && mask[i] != 0;
  unsigned ballot;
  const int total = block_ranks(m, warp_prefix, &ballot);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <typename T>
__global__ void scatter_kernel(const T* __restrict__ values,
                               const uint8_t* __restrict__ mask,
                               const long long* __restrict__ offsets,
                               T* __restrict__ out, long long n,
                               long long capacity) {
  __shared__ int warp_prefix[kWarps];
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const bool m = i < n && mask[i] != 0;
  unsigned ballot;
  block_ranks(m, warp_prefix, &ballot);
  if (m) {
    const int lane = threadIdx.x & 31;
    const long long pos = offsets[blockIdx.x] + warp_prefix[threadIdx.x >> 5] +
                          __popc(ballot & ((1u << lane) - 1u));
    if (pos < capacity) out[pos] = values[i];
  }
}

}  // namespace

// mask: uint8[n]; counts: int32[ceil(n / 1024)].
extern "C" int token_pack_count_launch(const void* mask, void* counts,
                                       long long n, void* stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  count_kernel<<<(unsigned)blocks, kBlock, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<int32_t*>(counts), n);
  return (int)cudaGetLastError();
}

// values: elem_size-byte words [n]; offsets: int64[ceil(n / 1024)], the
// exclusive prefix of the block counts; out: [capacity].
extern "C" int token_pack_scatter_launch(const void* values, const void* mask,
                                         const void* offsets, void* out,
                                         long long n, long long capacity,
                                         int elem_size, void* stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* off = static_cast<const long long*>(offsets);
  switch (elem_size) {
    case 1:
      scatter_kernel<uint8_t><<<(unsigned)blocks, kBlock, 0, s>>>(
          static_cast<const uint8_t*>(values), m, off,
          static_cast<uint8_t*>(out), n, capacity);
      break;
    case 4:
      scatter_kernel<unsigned int><<<(unsigned)blocks, kBlock, 0, s>>>(
          static_cast<const unsigned int*>(values), m, off,
          static_cast<unsigned int*>(out), n, capacity);
      break;
    case 8:
      scatter_kernel<unsigned long long><<<(unsigned)blocks, kBlock, 0, s>>>(
          static_cast<const unsigned long long*>(values), m, off,
          static_cast<unsigned long long*>(out), n, capacity);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
