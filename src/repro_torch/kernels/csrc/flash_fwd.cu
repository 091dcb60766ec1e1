// flash_fwd: online-softmax attention forward, O and the row log-sum-exp.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// src/repro/kernels/flash_attention.py (launched by `_fwd`), the prefill
// attention of every layer on the flash route, for f32 inputs, whose
// tolerance bf16 tensor cores cannot meet; bf16 runs on the tensor cores
// (flash_fwd_sm90.cu, flash_fwd_sm90_d256.cu), or here when the caller
// names this route (a timing comparison).  The wrapper picks the route by
// dtype and head dim.  Same function: f32
// accumulation; scale, then softcap c*tanh(s/c); mask qpos >= kpos when
// causal and (qpos - kpos) < window whenever a window is set (one-sided,
// even when non-causal); masked scores are the finite -1e30 of the
// reference, not -inf; O in the input dtype, LSE = m + log(max(l, 1e-30))
// in f32; GQA q-head h of batch b reads kv-head h / (Hq / Hkv).
//
// Bound on this card: operations.  At the serving shapes a (q, k) pair
// costs 4*D flops against Q+K+V+O bytes read once, far above the ~300
// flops/byte where HBM stops being the limit.  This first version does its
// arithmetic in f32 on the CUDA cores (no tensor cores yet), so it runs at
// a fraction of the bf16 tensor-core bound; wgmma/TMA are later work.
//
// Design.  The TPU kernel walked a sequential (bh, iq, ik) grid with the
// running max/sum/accumulator in VMEM scratch.  Here one CTA of 256 threads
// owns one (batch*head, 64-row q tile) and walks the k tiles in a loop.
// Q (64 x DP) stays in shared memory; each 64-row K and V tile is loaded
// once into shared memory, converted to f32 (DP = head_dim rounded up to
// the next of 16, 32, 64, 80, 128, 256, zero-padded).  Thread (ty, tx), ty, tx in [0, 16), owns
// q rows ty + 16i (i < 4), score columns tx + 16j (j < 4) and output
// columns tx + 16j (j < DP/16): a 4 x 4 register tile of S from float4
// reads, row max/sum reduced over the 16 lanes of a half-warp with
// shuffles, P staged through shared memory for the P.V product.  P reuses
// the K tile's space (dead by then; sized to hold either).  K rows are
// padded by 4 floats so a quarter-warp's float4 reads of eight K rows hit
// distinct banks.  Tiles wholly above the causal diagonal are skipped; the
// heaviest q tiles are scheduled first, on the (batch*head, q tile) grid of
// flash_grid.cuh, which holds neither extent to a grid limit.  Ragged
// edges are masked: q rows past Lq are computed on zeros and not stored;
// k columns past Lk score -inf, so they add exactly nothing (the running
// max starts at -1e30 and stays finite).  Shared memory is 197,632 bytes
// at head_dim 256, which needs the opt-in above 48 KB
// (cudaFuncAttributeMaxDynamicSharedMemorySize).
// exp/tanh/log are the accurate expf/tanhf/logf (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_grid.cuh"
#include "flash_tile.cuh"

namespace {

using flash::load_tile;
using flash::store;

constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;
constexpr int kLDP = kBK + 16;  // P rows: a warp's two rows 16 banks apart

// Floats of shared memory for head dims padded to DP: Q, then the K tile
// (which P reuses, so it is at least P's size), then V.
__host__ __device__ constexpr int smem_floats(int DP) {
  return kBQ * DP +
         (kBK * (DP + 4) > kBQ * kLDP ? kBK * (DP + 4) : kBQ * kLDP) +
         kBK * DP;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  long long Hq, Hkv, Lq, Lk, D;
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
  long long window;
  float scale, softcap;
  int causal, has_window, has_softcap;
};

template <int NJ, typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int DP = 16 * NJ;
  constexpr int LDQ = DP;      // Q rows: read by broadcast
  constexpr int LDK = DP + 4;  // K rows: eight rows per quarter-warp
  constexpr int LDV = DP;      // V columns: sixteen lanes side by side
  constexpr int LDP = kLDP;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kBQ * LDQ;
  float* Ps = Ks;
  float* Vs = Qs + smem_floats(DP) - kBK * LDV;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const int n_qt = static_cast<int>((p.Lq + kBQ - 1) / kBQ);
  if (flash::grid_tile() >= n_qt) return;  // past the last q tile
  const long long iq = n_qt - 1 - flash::grid_tile();  // heaviest first
  const long long b = bh / p.Hq, h = bh % p.Hq;
  const long long kvh = h / (p.Hq / p.Hkv);
  const long long q0 = iq * kBQ;
  const int D = static_cast<int>(p.D);
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile<kBK, DP, kThreads>(Qs, LDQ, qb, p.q_sl, q0, p.Lq, D);

  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  long long n_kt = (p.Lk + kBK - 1) / kBK;
  if (p.causal) {
    const long long live = (q0 + kBQ - 1) / kBK + 1;
    if (live < n_kt) n_kt = live;
  }
  for (long long kt = 0; kt < n_kt; ++kt) {
    const long long k0 = kt * kBK;
    __syncthreads();  // the last tile's P.V reads are done
    load_tile<kBK, DP, kThreads>(Ks, LDK, kb, p.k_sl, k0, p.Lk, D);
    load_tile<kBK, DP, kThreads>(Vs, LDV, vb, p.v_sl, k0, p.Lk, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LDK + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          s[i][j] = a;
        }
    }
    __syncthreads();  // every S read of the K tile is done: P may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long qpos = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long kpos = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
        bool keep = true;
        if (p.causal) keep = keep && qpos >= kpos;
        if (p.has_window) keep = keep && (qpos - kpos) < p.window;
        x = keep ? x : kNeg;
        if (kpos >= p.Lk) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        sum += e;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDP + kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float vv[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) vv[j] = Vs[(kk + t) * LDV + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float w = t == 0 ? pv[i].x : t == 1 ? pv[i].y
                        : t == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(w, vv[j], acc[i][j]);
        }
      }
    }
  }

  T* ob = static_cast<T*>(p.o) + bh * p.Lq * p.D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long qpos = q0 + ty + 16 * i;
    if (qpos >= p.Lq) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(ob + qpos * p.D + c, acc[i][j] / lc);
    }
    if (tx == 0) p.lse[bh * p.Lq + qpos] = m[i] + logf(lc);
  }
}

template <int NJ, typename T>
cudaError_t launch(const Params& p, long long bh, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(16 * NJ);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<NJ, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<NJ, T><<<flash::tile_grid(bh, (p.Lq + kBQ - 1) / kBQ),
                            kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Head dims pad up to 16, 32, 64, 80, 128 or 256: the configs' own widths
// (16 smoke, 32, 80 stablelm, 128 qwen/yi, 256 gemma2) run unpadded, any
// other multiple of 8 runs on zero columns, and the build makes 6 instances
// per dtype instead of 16.
template <typename T>
cudaError_t dispatch(const Params& p, long long bh, cudaStream_t st) {
  if (p.D <= 16) return launch<1, T>(p, bh, st);
  if (p.D <= 32) return launch<2, T>(p, bh, st);
  if (p.D <= 64) return launch<4, T>(p, bh, st);
  if (p.D <= 80) return launch<5, T>(p, bh, st);
  if (p.D <= 128) return launch<8, T>(p, bh, st);
  if (p.D <= 256) return launch<16, T>(p, bh, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Hq, Lq, D), k/v: (B, Hkv, Lk, D) with the given element strides
// (D contiguous; rows 16-byte aligned); o: (B, Hq, Lq, D) contiguous in the
// input dtype; lse: (B, Hq, Lq) f32.  head_dim a multiple of 8 up to 256,
// Hq a multiple of Hkv: the Python wrapper checks all of it.
extern "C" int repro_flash_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long B, long long Hq, long long Hkv, long long Lq, long long Lk,
    long long D, long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl, long long v_sb,
    long long v_sh, long long v_sl, int is_bf16, int causal,
    int has_window, long long window, int has_softcap, float softcap,
    float scale, void* stream) {
  Params p{q, k, v, o, static_cast<float*>(lse), Hq, Hkv, Lq, Lk, D,
           q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
           window, scale, softcap, causal, has_window, has_softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(p, B * Hq, st)
                                  : dispatch<float>(p, B * Hq, st);
  return static_cast<int>(err);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
