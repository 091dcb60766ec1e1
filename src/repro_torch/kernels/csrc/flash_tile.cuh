// Tile loads shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): rows of one (batch, head) slice of a (B, H, L, D) tensor,
// read 8 elements (16 bytes of bf16, 32 of f32) at a time and widened to
// f32 in shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

__device__ __forceinline__ void load8(const float* src, float* v) {
  const float4 a = reinterpret_cast<const float4*>(src)[0];
  const float4 b = reinterpret_cast<const float4*>(src)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float2 f = __bfloat1622float2(h[t]);
    v[2 * t] = f.x;
    v[2 * t + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Rows [row0, row0 + ROWS) of one slice, `D` columns in groups of 8, into
// shared memory as f32 with row stride `ld`; rows past `n_rows` and
// columns past D (up to the padded width DP) are zero.  All THREADS
// threads of the block take part.
template <int ROWS, int DP, int THREADS, typename T>
__device__ void load_tile(float* dst, int ld, const T* base, long long sl,
                          long long row0, long long n_rows, int D) {
  constexpr int kVecs = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kVecs; idx += THREADS) {
    const int r = idx / kVecs, c = (idx % kVecs) * 8;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows && c < D) load8(base + (row0 + r) * sl + c, v);
    float4* d = reinterpret_cast<float4*>(dst + r * ld + c);
    d[0] = make_float4(v[0], v[1], v[2], v[3]);
    d[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

}  // namespace flash
