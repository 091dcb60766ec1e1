// Shared pieces of the row-copy kernels: one warp copies one row of
// `row_bytes` bytes, 32 lanes on neighbouring vectors, and walks the rows
// with a grid-stride loop.  The kernels move bytes, so one build serves
// every element type; the widest vector (16, 8, 4, 2 or 1 bytes) that
// divides the row length and both base addresses is chosen per launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 32 * kWarpsPerBlock;
// 132 SMs x 16 blocks: about two waves of resident blocks; each warp then
// walks further rows instead of the grid growing with the row count.
constexpr long long kMaxBlocks = 132 * 16;

template <typename V>
__device__ __forceinline__ void copy_row(const char* __restrict__ src,
                                         char* __restrict__ dst,
                                         long long row_bytes, int lane) {
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  const long long n = row_bytes / static_cast<long long>(sizeof(V));
  for (long long k = lane; k < n; k += 32) d[k] = s[k];
}

inline int vector_bytes(const void* a, const void* b, long long row_bytes) {
  const uintptr_t m = reinterpret_cast<uintptr_t>(a) |
                      reinterpret_cast<uintptr_t>(b) |
                      static_cast<uintptr_t>(row_bytes);
  for (int v = 16; v > 1; v >>= 1)
    if ((m & static_cast<uintptr_t>(v - 1)) == 0) return v;
  return 1;
}

inline dim3 grid_for(long long rows) {
  long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (blocks < 1) blocks = 1;
  return dim3(static_cast<unsigned>(blocks));
}

}  // namespace repro

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
