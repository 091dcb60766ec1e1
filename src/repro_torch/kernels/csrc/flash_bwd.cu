// flash_bwd: the flash-attention backward, dQ and per-q-head dK, dV.
//
// Replaces the Pallas kernels `_dq_kernel` and `_dkv_kernel` of
// src/repro/kernels/flash_attention.py (launched by `_bwd`) on the CUDA
// cores, f32 or bf16, and runs only where a caller names its route
// ("simt": timing comparisons, tests).  The flash route's backward runs
// flash_bwd_f32tc.cu for f32 (3xTF32 on the tensor cores) and
// flash_bwd_sm90.cu (head_dim up to 128) or flash_bwd_sm90_d256.cu
// (above) for bf16.  Same function: the scores
// are recomputed in f32 (scale, then softcap c*tanh(s/c), then the masks:
// qpos >= kpos when causal, (qpos - kpos) < window whenever a window is
// set, one-sided even when non-causal, masked scores the finite -1e30),
// P = exp(s - LSE) from the forward's f32 LSE, dP = dO.V^T,
// dS = P * (dP - delta) * (1 - t^2 under softcap) * scale, zero where
// masked, with delta = rowsum(dO * O) computed by the caller from the
// stored O.  dQ = dS.K in q's dtype; dK = dS^T.Q and dV = P^T.dO per
// q-head in f32, which the caller sums over each GQA group in f32, as the
// reference does, so no two blocks write the same output and the result
// does not depend on the schedule (no atomics).
//
// Bound on this card: operations.  A live (q, k) pair costs 6*D flops in
// dQ (Q.K^T, dO.V^T, dS.K) and 8*D in dK/dV (Q.K^T, dO.V^T, P^T.dO,
// dS^T.Q) against Q, K, V, dO, O, dQ, dK, dV bytes read or written once,
// far above the ~300 flops/byte where HBM stops being the limit.  It does
// its arithmetic in f32 on the CUDA cores, as f32 inputs need: bf16 tensor
// cores cannot meet the f32 gradient tolerance.
//
// Design.  The TPU kernels walked sequential grids with accumulators in
// VMEM scratch: dQ over (bh, iq, ik), dK/dV over (bh, ik, iq).  Here one
// CTA of 256 threads owns one (batch*head, BT-row tile) and walks the
// other axis in a loop, with its accumulators in registers:
//   dq:  a q tile; Q and dO stay in shared memory, each K and V tile is
//        loaded once; thread (ty, tx), ty, tx in [0, 16), owns q rows
//        ty + 16i, score columns tx + 16j and dQ columns tx + 16j;
//   dkv: a k tile; K and V stay, each Q and dO tile (with its LSE and
//        delta) is loaded once; the thread owns k rows ty + 16i, q
//        columns tx + 16j, and dK, dV columns tx + 16j; it computes the
//        transposed scores S^T directly, so P^T and dS^T are staged through
//        shared memory row-major for the products with dO and Q.
// Operands read by broadcast (one row per half-warp) are stored with
// stride DP, those read by sixteen lanes in float4s with DP + 4, so a
// quarter-warp's eight rows hit distinct banks; the staged dS/P rows are
// BT + 16 apart, a warp's two rows 16 banks apart.  Inputs are widened to
// f32 in shared memory (DP = head_dim rounded up to 16, 32, 64, 80, 128 or
// 256, zero-padded).  BT is 64, or 32 at DP 256, where two 64-row f32
// accumulators per thread would spill and the tiles would not fit: shared
// memory peaks at 174,592 bytes (dkv, DP 128), opted in above 48 KB.
// Tiles wholly above the causal diagonal are skipped (each holds only
// P = 0, dS = 0: a row whose live keys are all masked has no in-range key
// above its diagonal), heaviest tiles first, on the (batch*head, tile) grid
// of flash_grid.cuh, which holds neither extent to a grid limit.  Ragged
// edges: rows and columns past Lq or Lk are computed on zeros, get P = 0
// and dS = 0, and are not stored.  exp/tanh are the accurate expf/tanhf
// (no fast math).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "flash_grid.cuh"
#include "flash_tile.cuh"

namespace {

using flash::load_tile;
using flash::store;

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B*Hq, Lq)
  const float* delta;  // (B*Hq, Lq)
  void* dq;            // (B*Hq, Lq, D), q's dtype
  float* dk;           // (B*Hq, Lk, D) f32, per q-head
  float* dv;           // (B*Hq, Lk, D) f32, per q-head
  long long Hq, Hkv, Lq, Lk, D;
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
  long long do_sb, do_sh, do_sl;
  long long window;
  float scale, softcap;
  int causal, has_window, has_softcap;
};

// Tile rows: 64, or 32 at head dims padded to 256.
__host__ __device__ constexpr int tile_rows(int NJ) { return NJ > 8 ? 32 : 64; }

// Floats of shared memory: two broadcast-read tiles (stride DP), two
// lane-read tiles (stride DP + 4), and `staged` BT x (BT + 16) tiles.
__host__ __device__ constexpr int smem_floats(int NJ, int staged) {
  return 2 * tile_rows(NJ) * 16 * NJ + 2 * tile_rows(NJ) * (16 * NJ + 4) +
         staged * tile_rows(NJ) * (tile_rows(NJ) + 16);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(float4 a, int t) {
  return t == 0 ? a.x : t == 1 ? a.y : t == 2 ? a.z : a.w;
}

// c[i][j] = sum_d A[ty + 16i][d] * B[tx + 16j][d]: A read by broadcast
// (stride LDA), B by the sixteen tx lanes (stride LDB).
template <int NI, int DP, int LDA, int LDB>
__device__ __forceinline__ void tile_dots(float (&c)[NI][NI], const float* A,
                                          const float* B, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) c[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; d += 4) {
    float4 a[NI], b[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LDA + d);
#pragma unroll
    for (int j = 0; j < NI; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LDB + d);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) c[i][j] = dot4(a[i], b[j], c[i][j]);
  }
}

// The reference's `_p_ds` for one score: returns P and sets `ds`.
__device__ __forceinline__ float p_ds(const Params& p, float sraw, float dp,
                                      float lse, float delta, long long qpos,
                                      long long kpos, float* ds) {
  float x = sraw * p.scale;
  float dcap = 1.f;
  if (p.has_softcap) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    dcap = 1.f - t * t;
  }
  bool keep = true;
  if (p.causal) keep = keep && qpos >= kpos;
  if (p.has_window) keep = keep && (qpos - kpos) < p.window;
  x = keep ? x : kNeg;
  float pr = expf(x - lse);
  float d = pr * (dp - delta) * dcap * p.scale;
  if (!keep) d = 0.f;
  if (qpos >= p.Lq || kpos >= p.Lk) {
    pr = 0.f;
    d = 0.f;
  }
  *ds = d;
  return pr;
}

// Causal tiles above the diagonal hold only zeros, unless a window of 0
// masks every key (then the reference's P is exp(0) = 1 everywhere).
__device__ __forceinline__ bool skip_above_diagonal(const Params& p) {
  return p.causal && !(p.has_window && p.window <= 0);
}

template <int NJ, typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  constexpr int DP = 16 * NJ;
  constexpr int BT = tile_rows(NJ);
  constexpr int NI = BT / 16;
  constexpr int LDA = DP;      // Q, dO: read by broadcast
  constexpr int LDB = DP + 4;  // K, V: read by the tx lanes
  constexpr int LDS = BT + 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BT * LDA;
  float* Ks = dOs + BT * LDA;
  float* Vs = Ks + BT * LDB;
  float* dSs = Vs + BT * LDB;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const int n_qt = static_cast<int>((p.Lq + BT - 1) / BT);
  if (flash::grid_tile() >= n_qt) return;  // past the last q tile
  const long long iq = n_qt - 1 - flash::grid_tile();  // heaviest first
  const long long b = bh / p.Hq, h = bh % p.Hq;
  const long long kvh = h / (p.Hq / p.Hkv);
  const long long q0 = iq * BT;
  const int D = static_cast<int>(p.D);
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile<BT, DP, kThreads>(Qs, LDA, qb, p.q_sl, q0, p.Lq, D);
  load_tile<BT, DP, kThreads>(dOs, LDA, dob, p.do_sl, q0, p.Lq, D);
  float lse[NI], delta[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const long long qpos = q0 + ty + 16 * i;
    lse[i] = qpos < p.Lq ? p.lse[bh * p.Lq + qpos] : 0.f;
    delta[i] = qpos < p.Lq ? p.delta[bh * p.Lq + qpos] : 0.f;
  }

  float acc[NI][NJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  long long n_kt = (p.Lk + BT - 1) / BT;
  if (skip_above_diagonal(p)) {
    const long long live = (q0 + BT - 1) / BT + 1;
    if (live < n_kt) n_kt = live;
  }
  for (long long kt = 0; kt < n_kt; ++kt) {
    const long long k0 = kt * BT;
    __syncthreads();  // the last tile's dS.K reads are done
    load_tile<BT, DP, kThreads>(Ks, LDB, kb, p.k_sl, k0, p.Lk, D);
    load_tile<BT, DP, kThreads>(Vs, LDB, vb, p.v_sl, k0, p.Lk, D);
    __syncthreads();

    float s[NI][NI], dp[NI][NI];
    tile_dots<NI, DP, LDA, LDB>(s, Qs, Ks, ty, tx);
    tile_dots<NI, DP, LDA, LDB>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        float ds;
        p_ds(p, s[i][j], dp[i][j], lse[i], delta[i], q0 + ty + 16 * i,
             k0 + tx + 16 * j, &ds);
        dSs[(ty + 16 * i) * LDS + tx + 16 * j] = ds;
      }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BT; kk += 4) {
      float4 dsv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i)
        dsv[i] = *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * LDS +
                                                  kk);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float kr[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) kr[j] = Ks[(kk + t) * LDB + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float w = lane(dsv[i], t);
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(w, kr[j], acc[i][j]);
        }
      }
    }
  }

  T* out = static_cast<T*>(p.dq) + bh * p.Lq * p.D;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const long long qpos = q0 + ty + 16 * i;
    if (qpos >= p.Lq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) store(out + qpos * p.D + c, acc[i][j]);
    }
  }
}

template <int NJ, typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Params p) {
  constexpr int DP = 16 * NJ;
  constexpr int BT = tile_rows(NJ);
  constexpr int NI = BT / 16;
  constexpr int LDA = DP;      // K, V: read by broadcast
  constexpr int LDB = DP + 4;  // Q, dO: read by the tx lanes
  constexpr int LDS = BT + 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BT * LDA;
  float* Qs = Vs + BT * LDA;
  float* dOs = Qs + BT * LDB;
  float* Ps = dOs + BT * LDB;  // P^T: k rows, q columns
  float* dSs = Ps + BT * LDS;  // dS^T
  __shared__ float lse_s[BT], delta_s[BT];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long bh = blockIdx.x;
  const long long ik = flash::grid_tile();  // causal: low ones see most q
  if (ik * BT >= p.Lk) return;  // past the last k tile
  const long long b = bh / p.Hq, h = bh % p.Hq;
  const long long kvh = h / (p.Hq / p.Hkv);
  const long long k0 = ik * BT;
  const int D = static_cast<int>(p.D);
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile<BT, DP, kThreads>(Ks, LDA, kb, p.k_sl, k0, p.Lk, D);
  load_tile<BT, DP, kThreads>(Vs, LDA, vb, p.v_sl, k0, p.Lk, D);

  float dk[NI][NJ], dv[NI][NJ];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[i][j] = 0.f;
      dv[i][j] = 0.f;
    }

  const long long n_qt = (p.Lq + BT - 1) / BT;
  for (long long qt = skip_above_diagonal(p) ? ik : 0; qt < n_qt; ++qt) {
    const long long q0 = qt * BT;
    __syncthreads();  // the last tile's products are done
    load_tile<BT, DP, kThreads>(Qs, LDB, qb, p.q_sl, q0, p.Lq, D);
    load_tile<BT, DP, kThreads>(dOs, LDB, dob, p.do_sl, q0, p.Lq, D);
    if (threadIdx.x < BT) {
      const long long qpos = q0 + threadIdx.x;
      lse_s[threadIdx.x] = qpos < p.Lq ? p.lse[bh * p.Lq + qpos] : 0.f;
      delta_s[threadIdx.x] = qpos < p.Lq ? p.delta[bh * p.Lq + qpos] : 0.f;
    }
    __syncthreads();

    float s[NI][NI], dp[NI][NI];
    tile_dots<NI, DP, LDA, LDB>(s, Ks, Qs, ty, tx);
    tile_dots<NI, DP, LDA, LDB>(dp, Vs, dOs, ty, tx);
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int c = tx + 16 * j;
        float ds;
        const float pr = p_ds(p, s[i][j], dp[i][j], lse_s[c], delta_s[c],
                              q0 + c, k0 + ty + 16 * i, &ds);
        Ps[(ty + 16 * i) * LDS + c] = pr;
        dSs[(ty + 16 * i) * LDS + c] = ds;
      }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < BT; qq += 4) {
      float4 pv[NI], dsv[NI];
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        pv[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * LDS +
                                                 qq);
        dsv[i] = *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * LDS +
                                                  qq);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float dor[NJ], qr[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dor[j] = dOs[(qq + t) * LDB + tx + 16 * j];
          qr[j] = Qs[(qq + t) * LDB + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < NI; ++i) {
          const float wp = lane(pv[i], t), wd = lane(dsv[i], t);
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            dv[i][j] = fmaf(wp, dor[j], dv[i][j]);
            dk[i][j] = fmaf(wd, qr[j], dk[i][j]);
          }
        }
      }
    }
  }

  float* dko = p.dk + bh * p.Lk * p.D;
  float* dvo = p.dv + bh * p.Lk * p.D;
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const long long kpos = k0 + ty + 16 * i;
    if (kpos >= p.Lk) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < D) {
        dko[kpos * p.D + c] = dk[i][j];
        dvo[kpos * p.D + c] = dv[i][j];
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int staged, int NJ, long long rows,
                   long long bh, const Params& p, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(NJ, staged);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int bt = tile_rows(NJ);
  kernel<<<flash::tile_grid(bh, (rows + bt - 1) / bt), kThreads, smem,
           stream>>>(p);
  return cudaGetLastError();
}

template <int NJ, typename T>
cudaError_t launch_one(bool dq, const Params& p, long long bh,
                       cudaStream_t st) {
  return dq ? launch(flash_dq_kernel<NJ, T>, 1, NJ, p.Lq, bh, p, st)
            : launch(flash_dkv_kernel<NJ, T>, 2, NJ, p.Lk, bh, p, st);
}

// Head dims pad up to the forward's six widths.
template <typename T>
cudaError_t dispatch(bool dq, const Params& p, long long bh,
                     cudaStream_t st) {
  if (p.D <= 16) return launch_one<1, T>(dq, p, bh, st);
  if (p.D <= 32) return launch_one<2, T>(dq, p, bh, st);
  if (p.D <= 64) return launch_one<4, T>(dq, p, bh, st);
  if (p.D <= 80) return launch_one<5, T>(dq, p, bh, st);
  if (p.D <= 128) return launch_one<8, T>(dq, p, bh, st);
  if (p.D <= 256) return launch_one<16, T>(dq, p, bh, st);
  return cudaErrorInvalidValue;
}

int run(bool dq, Params& p, long long B, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_bf16 ? dispatch<__nv_bfloat16>(dq, p, B * p.Hq, st)
                                  : dispatch<float>(dq, p, B * p.Hq, st);
  return static_cast<int>(err);
}

}  // namespace

// q, dout: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D), each with the given
// element strides (D contiguous, rows 16-byte aligned), one dtype; lse and
// delta: (B, Hq, Lq) f32 contiguous.  dq: (B, Hq, Lq, D) contiguous in the
// input dtype.  dk, dv: (B, Hq, Lk, D) f32 contiguous, one slice per
// q-head.  head_dim a multiple of 8 up to 256, Hq a multiple of Hkv: the
// Python wrapper checks all of it.
#define REPRO_FLASH_BWD_ARGS                                                  \
  const void *q, const void *k, const void *v, const void *dout,             \
      const void *lse, const void *delta
#define REPRO_FLASH_BWD_SHAPE                                                 \
  long long B, long long Hq, long long Hkv, long long Lq, long long Lk,      \
      long long D, long long q_sb, long long q_sh, long long q_sl,           \
      long long k_sb, long long k_sh, long long k_sl, long long v_sb,        \
      long long v_sh, long long v_sl, long long do_sb, long long do_sh,      \
      long long do_sl, int is_bf16, int causal, int has_window,              \
      long long window, int has_softcap, float softcap, float scale,         \
      void *stream
#define REPRO_FLASH_BWD_PARAMS(dq_, dk_, dv_)                                 \
  Params p{q, k, v, dout, static_cast<const float*>(lse),                    \
           static_cast<const float*>(delta), dq_, dk_, dv_, Hq, Hkv, Lq, Lk, \
           D, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, do_sb,   \
           do_sh, do_sl, window, scale, softcap, causal, has_window,         \
           has_softcap}

extern "C" int repro_flash_dq(REPRO_FLASH_BWD_ARGS, void* dq,
                              REPRO_FLASH_BWD_SHAPE) {
  REPRO_FLASH_BWD_PARAMS(dq, nullptr, nullptr);
  return run(true, p, B, is_bf16, stream);
}

extern "C" int repro_flash_dkv(REPRO_FLASH_BWD_ARGS, void* dk, void* dv,
                               REPRO_FLASH_BWD_SHAPE) {
  REPRO_FLASH_BWD_PARAMS(nullptr, static_cast<float*>(dk),
                         static_cast<float*>(dv));
  return run(false, p, B, is_bf16, stream);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
