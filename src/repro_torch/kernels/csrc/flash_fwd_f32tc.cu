// flash_fwd_f32tc: online-softmax attention forward for f32 inputs on the
// tensor cores in 3xTF32, O and the row log-sum-exp.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// src/repro/kernels/flash_attention.py (launched by `_fwd`) for f32 q, k,
// v: the prefill attention of the f32 serving path and the forward of the
// f32 training comparison, at every head_dim the wrapper takes.  bf16 runs
// the sm90 kernels (flash_fwd_sm90.cu, flash_fwd_sm90_d256.cu);
// flash_fwd.cu, the same function on the CUDA cores, runs only when the
// caller names its route (a timing comparison).  The f32 backward
// (flash_bwd_f32tc.cu) reads this kernel's LSE.  Same function as
// flash_fwd.cu: f32 accumulation; scale, then softcap c*tanh(s/c); mask
// qpos >= kpos when causal and (qpos - kpos) < window whenever a window is
// set (one-sided, even when non-causal); masked scores are the finite -1e30 of
// the reference, not -inf; O and LSE = m + log(max(l, 1e-30)) in f32; GQA
// q-head h of batch b reads kv-head h / (Hq / Hkv).
//
// Bound on this card: operations.  A live (q, k) pair costs 4*D flops
// against Q+K+V+O bytes read once.  On the CUDA cores f32 peaks at 67
// TFLOP/s.  The TF32 tensor cores run 495 TFLOP/s but keep 10 mantissa
// bits (about 1e-3), too coarse for the reference's f32 tolerance (rtol
// 1e-4, atol 1e-5).  3xTF32 keeps close to f32: every operand x of both
// products, S = Q.K^T and O += P.V, is split into hi = tf32(x) and lo =
// x - hi, TF32 by truncation (hi's low 13 bits are cleared here; lo is
// passed whole, and the tensor core reads only the 19 bits of a TF32
// operand, as CUTLASS's 3xTF32 relies on), and a product is lo*hi + hi*lo
// + hi*hi summed in f32.  The dropped lo*lo and the truncation of lo are
// below 2^-20 of a product.  Three tensor-core products per useful one put
// the bound at 495/3 = 165 TFLOP/s.  The tensor core's adder truncates:
// summed across 2048 keys in the accumulators, O drifts by about 2.5e-5
// of itself, so up to head_dim 128 each tile's P.V is summed from zero
// and folded into O by one rounded fmaf (the CPU emulation's order).
//
// Design.  `mma.sync.m16n8k8` TF32 with fragments read from shared memory
// and split in registers (wgmma takes TF32 operands from shared memory only
// K-major, and V is [keys, D], MN-major for P.V).  One CTA of 8 warps owns
// one (batch*head, 128-row q tile), each warp 16 q rows, and walks the k
// tiles in a loop: Q stays in shared memory, K and V tiles arrive by
// `cp.async` in a 2-stage ring, so the next tile loads while this one is
// used.  BK = 64 keys a tile up to head_dim 128 (202,752 bytes of shared
// memory at 128); at head_dim 256, where a warp's 16 x 256 O accumulator is
// 128 f32 a thread, BK = 16 (199,680 bytes).  Rows are padded by 4 floats,
// so every fragment read (ldmatrix of Q's and K's 8 x 4 blocks; V's rows
// 2t, 2t+1 by plain loads) hits 32 distinct banks.  The three products of
// a step are issued pass by pass over 4 output tiles (all lo*hi, then
// hi*lo, then hi*hi), so independent products stand between two into one
// accumulator.  S comes out of the accumulators in the C layout (rows g,
// g+8; keys 2t, 2t+1 of each 8) and is the A operand of P.V as it stands:
// the contraction over a tile's 8 keys takes them in the order 0, 2, 4, 6,
// 1, 3, 5, 7, so A's columns t and t + 4 are keys 2t and 2t + 1, and V's B
// fragment reads rows 2t and 2t + 1 to match.  P is split into hi and lo in
// registers, as the bf16 kernels split P into two bf16 halves.  Row max and
// sum stay per thread and are reduced over the quad (the max per tile, the
// sum once at the end).  Tiles wholly above the causal diagonal are
// skipped by the CTA, and a warp skips a tile above its own 16 rows
// (exact: those scores give exp(-1e30 - m) = 0); the heaviest q tiles are
// scheduled first, on the (batch*head, q tile) grid of flash_grid.cuh.
// Ragged edges: rows past Lq and columns past the head dim load as zeros
// (cp.async with no source bytes); keys past Lk score -inf, so they add
// exactly nothing.  Head dims pad up to 16, 32, 64, 80, 128 or 256 as in
// flash_fwd.cu.  exp is exp2f(x * log2 e) (2 ulp, as the sm90 kernels'),
// tanh and log the accurate tanhf and logf (no fast math).
// tools/flash_f32tc_probe.py times the tilings, the fold, expf and a single
// TF32 product this design was chosen over.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_grid.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// sign, exponent and the 10 mantissa bits that TF32 keeps
constexpr uint32_t kTf32 = 0xffffe000u;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  long long Hq, Hkv, Lq, Lk, D;
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
  long long window;
  float scale, softcap;
  int causal, has_window, has_softcap;
};

// x = hi + lo + (below 2^-20 of x): hi = tf32(x) by truncation, lo = x - hi
// exactly in f32, whose low 13 bits the tensor core drops (it reads the 19
// bits of a TF32 operand), which truncates lo to TF32 too
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi,
                                      uint32_t& lo) {
  hi = x & kTf32;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// c += a * b on one 16 x 8 x 8 TF32 tile (f32 accumulators)
__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 4 TF32 matrices (8 rows of 16 bytes each, one row address a
// lane): register i of lane l is element (l / 4, l % 4) of matrix i.
__device__ __forceinline__ void ldsm4(uint32_t* r, const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row))
      : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of one (batch, head) slice into shared memory
// with row stride DP + 4, 4 floats a copy; rows past n_rows and columns
// past D (up to DP) are zero.  All THREADS threads take part.
template <int ROWS, int DP, int THREADS>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long sl, long long row0,
                                          long long n_rows, int D) {
  constexpr int kVecs = DP / 4;
  for (int idx = threadIdx.x; idx < ROWS * kVecs; idx += THREADS) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    const bool valid = row0 + r < n_rows && c < D;
    cp_async16(dst + r * (DP + 4) + c,
               valid ? base + (row0 + r) * sl + c : base, valid);
  }
}

// One 3xTF32 step over G n-tiles: the lo*hi products of every n-tile,
// then the hi*lo ones, then hi*hi, so that G independent products stand
// between two into one accumulator.
template <int G>
__device__ __forceinline__ void mma3(float (*c)[4], const uint32_t* ah,
                                     const uint32_t* al,
                                     const uint32_t (*bh)[2],
                                     const uint32_t (*bl)[2]) {
#pragma unroll
  for (int n = 0; n < G; ++n) mma(c[n], al, bh[n]);
#pragma unroll
  for (int n = 0; n < G; ++n) mma(c[n], ah, bl[n]);
#pragma unroll
  for (int n = 0; n < G; ++n) mma(c[n], ah, bh[n]);
}

template <int DP, int NW, int BK>
__host__ __device__ constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * (16 * NW + 4 * BK) * (DP + 4);
}

// One CTA of NW warps owns 16 * NW q rows, each warp 16; K/V tiles of BK
// keys.
template <int DP, int NW, int BK>
__global__ void __launch_bounds__(32 * NW, 1)
    flash_fwd_f32tc_kernel(const Params p) {
  constexpr int kThreads = 32 * NW;
  constexpr int BQ = 16 * NW;
  constexpr int LD = DP + 4;
  constexpr int NS = BK / 8;  // 8-key tiles of S (and k-steps of P.V)
  constexpr int NO = DP / 8;  // 8-column tiles of O (and k-steps of S)
  constexpr int GS = NS < 4 ? NS : 4;  // n-tiles a 3xTF32 step of S
  constexpr int GO = NO % 4 == 0 ? 4 : 2;  // and of P.V
  // each tile's P.V summed from zero and folded into O with one rounding;
  // at head_dim 256 the fold's registers would spill, and O is summed in
  // the tensor core across the keys
  constexpr bool kFold = DP <= 128;
  static_assert(NS % GS == 0 && GS % 2 == 0 && NO % GO == 0,
                "tile shapes");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + BQ * LD;  // stage s: K at 2s*BK*LD, then V

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = blockIdx.x;
  const int n_qt = static_cast<int>((p.Lq + BQ - 1) / BQ);
  if (flash::grid_tile() >= n_qt) return;  // past the last q tile
  const long long iq = n_qt - 1 - flash::grid_tile();  // heaviest first
  const long long b = bh / p.Hq, h = bh % p.Hq;
  const long long kvh = h / (p.Hq / p.Hkv);
  const long long q0 = iq * BQ;
  const long long qw0 = q0 + 16 * warp;  // this warp's first q row
  const int D = static_cast<int>(p.D);
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  long long n_kt = (p.Lk + BK - 1) / BK;
  if (p.causal) {
    const long long live = (q0 + BQ - 1) / BK + 1;
    if (live < n_kt) n_kt = live;
  }
  load_tile<BQ, DP, kThreads>(Qs, qb, p.q_sl, q0, p.Lq, D);
  if (n_kt > 0) {
    load_tile<BK, DP, kThreads>(KVs, kb, p.k_sl, 0, p.Lk, D);
    load_tile<BK, DP, kThreads>(KVs + BK * LD, vb, p.v_sl, 0, p.Lk, D);
  }
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int mi = lane >> 3, mr = lane & 7;
  const float* qrow = Qs + (16 * warp + mr + 8 * (mi & 1)) * LD +
                      4 * (mi >> 1);
  const int krow = (mr + 8 * (mi >> 1)) * LD + 4 * (mi & 1);

  for (long long kt = 0; kt < n_kt; ++kt) {
    float* Ks = KVs + (kt & 1) * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;
    if (kt + 1 < n_kt) {
      // the other stage was released by the last iteration's barrier
      float* Kn = KVs + ((kt + 1) & 1) * 2 * BK * LD;
      load_tile<BK, DP, kThreads>(Kn, kb, p.k_sl, (kt + 1) * BK, p.Lk, D);
      load_tile<BK, DP, kThreads>(Kn + BK * LD, vb, p.v_sl, (kt + 1) * BK,
                                  p.Lk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const long long k0 = kt * BK;
    // a tile wholly above this warp's rows adds exp(-1e30 - m) = 0
    if (!(p.causal && k0 > qw0 + 15)) {
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll 2
      for (int d = 0; d < DP; d += 8) {
        uint32_t raw[4], ah[4], al[4];
        ldsm4(raw, qrow + d);
#pragma unroll
        for (int e = 0; e < 4; ++e) split(raw[e], ah[e], al[e]);
#pragma unroll
        for (int j0 = 0; j0 < NS; j0 += GS) {
          uint32_t bh_[GS][2], bl_[GS][2];
#pragma unroll
          for (int j = 0; j < GS; j += 2) {
            // b0, b1 of n-tile j0 + j, then of j0 + j + 1
            ldsm4(raw, Ks + (8 * (j0 + j)) * LD + krow + d);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split(raw[e], bh_[j + e / 2][e % 2], bl_[j + e / 2][e % 2]);
          }
          mma3<GS>(s + j0, ah, al, bh_, bl_);
        }
      }

      // scale, softcap and masks; element e of tile j is row
      // qw0 + g + 8*(e/2), key k0 + 8j + 2t + e%2
      const bool masked = (p.causal && k0 + BK - 1 > qw0) || p.has_window ||
                          k0 + BK > p.Lk;
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[j][e] * p.scale;
          if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
          if (masked) {
            const long long qpos = qw0 + g + 8 * (e >> 1);
            const long long kpos = k0 + 8 * j + 2 * t + (e & 1);
            bool keep = true;
            if (p.causal) keep = keep && qpos >= kpos;
            if (p.has_window) keep = keep && (qpos - kpos) < p.window;
            x = keep ? x : kNeg;
            if (kpos >= p.Lk) x = -INFINITY;
          }
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = exp2f((s[j][e] - m[e >> 1]) * kLog2e);
          l[e >> 1] += pe;
          s[j][e] = pe;
        }
      if constexpr (!kFold) {
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      }

      // O = alpha * O + P.V, GO output tiles at a time.  With kFold the
      // tile's P.V is summed from zero in the tensor core, whose adder
      // truncates, and folded into O by one rounded fmaf, so the
      // truncation does not pile up over the whole key range.  Tile j's
      // keys are taken in the order 2t (A column t), 2t + 1 (A column
      // t + 4).
#pragma unroll
      for (int n0 = 0; n0 < NO; n0 += GO) {
        float part[GO][4];
#pragma unroll
        for (int n = 0; n < GO; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          uint32_t ah[4], al[4];
          split(__float_as_uint(s[j][0]), ah[0], al[0]);
          split(__float_as_uint(s[j][2]), ah[1], al[1]);
          split(__float_as_uint(s[j][1]), ah[2], al[2]);
          split(__float_as_uint(s[j][3]), ah[3], al[3]);
          const float* vr = Vs + (8 * j + 2 * t) * LD + g + 8 * n0;
          uint32_t bh_[GO][2], bl_[GO][2];
#pragma unroll
          for (int n = 0; n < GO; ++n) {
            split(__float_as_uint(vr[8 * n]), bh_[n][0], bl_[n][0]);
            split(__float_as_uint(vr[LD + 8 * n]), bh_[n][1], bl_[n][1]);
          }
          mma3<GO>(kFold ? part : acc + n0, ah, al, bh_, bl_);
        }
        if constexpr (kFold) {
#pragma unroll
          for (int n = 0; n < GO; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e >> 1],
                                    part[n][e]);
        }
      }
    }
    __syncthreads();  // every read of this stage is done: it may refill
  }
  cp_async_wait<0>();  // no copy outlives the block (n_kt == 0)

  float* ob = p.o + bh * p.Lq * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float lc = fmaxf(lr, 1e-30f);
    const long long qpos = qw0 + g + 8 * r;
    if (qpos >= p.Lq) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < D)
        *reinterpret_cast<float2*>(ob + qpos * p.D + c) =
            make_float2(acc[n][2 * r] / lc, acc[n][2 * r + 1] / lc);
    }
    if (t == 0) p.lse[bh * p.Lq + qpos] = m[r] + logf(lc);
  }
}

template <int DP, int NW, int BK>
cudaError_t launch(const Params& p, long long bh, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP, NW, BK>();
  static_assert(smem <= 232448, "over the 227 KB a block may use");
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32tc_kernel<DP, NW, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32tc_kernel<DP, NW, BK>
      <<<flash::tile_grid(bh, (p.Lq + 16 * NW - 1) / (16 * NW)), 32 * NW,
         smem, stream>>>(p);
  return cudaGetLastError();
}

// Head dims pad up to 16, 32, 64, 80, 128 or 256, as flash_fwd.cu's.
cudaError_t dispatch(const Params& p, long long bh, cudaStream_t st) {
  if (p.D <= 16) return launch<16, 8, 64>(p, bh, st);
  if (p.D <= 32) return launch<32, 8, 64>(p, bh, st);
  if (p.D <= 64) return launch<64, 8, 64>(p, bh, st);
  if (p.D <= 80) return launch<80, 8, 64>(p, bh, st);
  if (p.D <= 128) return launch<128, 8, 64>(p, bh, st);
  if (p.D <= 256) return launch<256, 8, 16>(p, bh, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q: (B, Hq, Lq, D), k/v: (B, Hkv, Lk, D) f32 with the given element
// strides (D contiguous; rows 16-byte aligned); o: (B, Hq, Lq, D) f32
// contiguous; lse: (B, Hq, Lq) f32.  head_dim a multiple of 8 up to 256,
// Hq a multiple of Hkv: the Python wrapper checks all of it.
extern "C" int repro_flash_fwd_f32tc(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long B, long long Hq, long long Hkv, long long Lq, long long Lk,
    long long D, long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl, long long v_sb,
    long long v_sh, long long v_sl, int causal, int has_window,
    long long window, int has_softcap, float softcap, float scale,
    void* stream) {
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),
           static_cast<const float*>(v), static_cast<float*>(o),
           static_cast<float*>(lse), Hq, Hkv, Lq, Lk, D,
           q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl,
           window, scale, softcap, causal, has_window, has_softcap};
  return static_cast<int>(
      dispatch(p, B * Hq, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
