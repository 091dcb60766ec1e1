// flash_bwd_f32tc: the flash-attention backward for f32 inputs on the
// tensor cores in 3xTF32, dQ and per-q-head dK, dV.
//
// Replaces the Pallas kernels `_dq_kernel` and `_dkv_kernel` of
// src/repro/kernels/flash_attention.py:146 and :166 (launched by `_bwd` at
// :190) for f32 q, k, v, dO: the attention backward of the f32 training
// path, at every head_dim the wrapper takes.  bf16 runs the sm90 kernels
// (flash_bwd_sm90.cu, flash_bwd_sm90_d256.cu); flash_bwd.cu, the same
// function on the CUDA cores, runs only when the caller names its route
// (a timing comparison).  Same function as flash_bwd.cu: the scores are
// recomputed in f32 (scale, then softcap c*tanh(s/c), then the masks:
// qpos >= kpos when causal, (qpos - kpos) < window whenever a window is
// set, one-sided even when non-causal, masked scores the finite -1e30),
// P = exp(s - LSE) from flash_fwd_f32tc.cu's f32 LSE, dP = dO.V^T,
// dS = P * (dP - delta) * (1 - t^2 under softcap) * scale, zero where
// masked, with delta = rowsum(dO * O) from the caller.  dQ = dS.K; dK =
// dS^T.Q and dV = P^T.dO per q-head, which the caller sums over each GQA
// group, so no two blocks write one output (no atomics).
//
// Bound on this card: operations.  A live (q, k) pair costs 6*D flops in
// dQ (Q.K^T, dO.V^T, dS.K) and 8*D in dK/dV (K.Q^T, V.dO^T, P^T.dO,
// dS^T.Q).  The CUDA cores run f32 at 67 TFLOP/s; here every product is
// 3xTF32 on the tensor cores, as in flash_fwd_f32tc.cu: each operand x is
// split in registers into hi = tf32(x) by truncation and lo = x - hi
// (the tensor core reads lo's 19 TF32 bits), and a product is lo*hi +
// hi*lo + hi*hi summed in f32, so the bound is 495/3 = 165 TFLOP/s.  The
// tensor core's adder truncates; every accumulator that spans more than
// one tile (dQ across the k tiles, dK and dV across the q tiles) is
// summed tile by tile from zero in the tensor core and folded into its
// f32 total with one rounded add, so the truncation does not pile up over
// the sequence.
//
// Design.  `mma.sync.m16n8k8` TF32 (wgmma takes TF32 B only K-major, and
// dQ += dS.K, dV += P^T.dO and dK += dS^T.Q read their B MN-major).  A CTA
// of 8 warps owns one batch*head's tile of rows, on the (batch*head, tile)
// grid of flash_grid.cuh, heaviest tiles first.  Where one warp's
// accumulators would not fit its registers beside the scores, a pair of
// warps shares 16 rows: the two split the work by role and meet once a
// tile at a named barrier, exchanging fragments through shared memory in
// the C layout (each lane reads what the same lane of the other warp
// wrote, conflict-free).
//   dq:  Q and dO stay in shared memory, K and V tiles of BK keys arrive
//        by `cp.async` in a 2-stage ring.  Up to head_dim 128 each warp
//        owns 16 q rows (128 a CTA), computes S = Q.K^T and dP = dO.V^T,
//        forms dS and adds dS.K into its dQ, as flash_fwd_f32tc.cu walks
//        its k tiles.  At 256 (dQ alone 128 f32 a thread) a pair owns 16
//        rows (64 a CTA): role 0 computes S and from it Pd = P * (1 - t^2)
//        * scale (zero where masked), role 1 dP less delta; each hands its
//        tile to the other, both form dS = Pd * (dP - delta) (the same
//        products in both), and each adds dS.K into its own half of dQ's
//        columns;
//   dkv: pairs at every head dim (dK and dV of 16 keys take 2 * D / 2 f32
//        a thread), 64 keys a CTA; K and V stay, Q and dO tiles of BQ rows
//        (with their LSE and delta) arrive by `cp.async` in a 2-stage
//        ring.  Role 0 computes S^T = K.Q^T, P^T and Pd^T, hands Pd^T to
//        role 1 and adds P^T.dO into dV; role 1 computes dP^T = V.dO^T,
//        forms dS^T = Pd^T * (dP^T - delta) and adds dS^T.Q into dK.
// So no P^T or dS^T is staged for a transpose: the first product's B
// operand (K for S, V for dP; Q, dO for S^T, dP^T) is stored [rows, D],
// K-major, and read with `ldmatrix`; the product's accumulators (rows g,
// g + 8; columns 2t, 2t + 1 of each 8) are the A operand of the second
// product as they stand, its contraction over an 8-column tile taken in
// the order 0, 2, 4, 6, 1, 3, 5, 7, so B reads rows 2t and 2t + 1 (plain
// loads), exactly as flash_fwd_f32tc.cu feeds P into P.V.  A warp holds
// one 16 x D accumulator (dQ up to 128, dV or dK) or half of one (dQ at
// 256): at most 128 f32 a thread, where one warp's dK and dV at head_dim
// 256 would take 256.  The three products of a step are issued pass by pass over up to 4
// output tiles (all lo*hi, then hi*lo, then hi*hi).  Rows are padded by 4
// floats, so every fragment read hits 32 distinct banks.  Tiles: BK = 32
// (dq) and BQ = 64 (dkv) up to head_dim 128 (202,752 and 220,160 bytes of
// shared memory at 128), both 16 at 256 (207,872 and 204,032 bytes).
// Tiles wholly above the causal diagonal are skipped by the CTA, and a
// warp skips a tile above its own 16 rows (each holds only P = 0, dS = 0
// unless a window of 0 or less
// masks every key: the reference's P is then exp(0) = 1 everywhere, and
// nothing is skipped).  Ragged edges: rows past Lq or Lk and columns past
// the head dim load as zeros (cp.async with no source bytes), get P = 0
// and dS = 0, and are not stored.  Head dims pad up to 16, 32, 64, 80, 128
// or 256 as in flash_bwd.cu.  exp is exp2f((x - LSE) * log2 e), the
// difference taken first so a row whose every key is masked keeps P = 1;
// tanh the accurate tanhf (no fast math).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_grid.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
// sign, exponent and the 10 mantissa bits that TF32 keeps
constexpr uint32_t kTf32 = 0xffffe000u;
constexpr int kWarps = 8;  // 4 pairs
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 64;  // a CTA's rows where pairs own 16 each

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;    // (B*Hq, Lq)
  const float* delta;  // (B*Hq, Lq)
  float* dq;           // (B*Hq, Lq, D)
  float* dk;           // (B*Hq, Lk, D), per q-head
  float* dv;           // (B*Hq, Lk, D), per q-head
  long long Hq, Hkv, Lq, Lk, D;
  long long q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl;
  long long do_sb, do_sh, do_sl;
  long long window;
  float scale, softcap;
  int causal, has_window, has_softcap;
};

// x = hi + lo + (below 2^-20 of x): hi = tf32(x) by truncation, lo = x - hi
// exactly in f32, whose low 13 bits the tensor core drops
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

// One 3xTF32 step over G n-tiles: the lo*hi products of every n-tile,
// then the hi*lo ones, then hi*hi.
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

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The two warps of pair `pair` (warps pair and pair + 4) meet.
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" :: "r"(pair + 1) : "memory");
}

// Rows [row0, row0 + ROWS) of one (batch, head) slice into shared memory
// with row stride DP + 4, 4 floats a copy; rows past n_rows and columns
// past D (up to DP) are zero.
template <int ROWS, int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* base,
                                          long long sl, long long row0,
                                          long long n_rows, int D) {
  constexpr int kVecs = DP / 4;
  for (int idx = threadIdx.x; idx < ROWS * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = (idx % kVecs) * 4;
    const bool valid = row0 + r < n_rows && c < D;
    cp_async16(dst + r * (DP + 4) + c,
               valid ? base + (row0 + r) * sl + c : base, valid);
  }
}

// Entries [row0, row0 + ROWS) of one row of LSE or delta, zero past n.
template <int ROWS>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         long long row0, long long n) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool valid = row0 + i < n;
    cp_async4(dst + i, valid ? src + row0 + i : src, valid);
  }
}

// Causal tiles above the diagonal hold only zeros, unless a window of 0
// or less masks every key (then the reference's P is exp(0) = 1).
__device__ __forceinline__ bool skip_above_diagonal(const Params& p) {
  return p.causal && !(p.has_window && p.window <= 0);
}

// The reference's `_p_ds` for one raw score s: returns P and sets pd to
// dS / (dP - delta) = P * (1 - t^2 under softcap) * scale, zero where
// masked.  With `masked` false the tile is known to be wholly kept and in
// range.
__device__ __forceinline__ float p_and_pd(const Params& p, float s,
                                          float lse, long long qpos,
                                          long long kpos, bool masked,
                                          float& pd) {
  float x = s * p.scale, dcap = 1.f;
  if (p.has_softcap) {
    const float th = tanhf(x / p.softcap);
    x = p.softcap * th;
    dcap = 1.f - th * th;
  }
  bool keep = true;
  if (masked) {
    if (p.causal) keep = qpos >= kpos;
    if (p.has_window) keep = keep && (qpos - kpos) < p.window;
    x = keep ? x : kNeg;
  }
  float pr = exp2f((x - lse) * kLog2e);
  pd = keep ? pr * dcap * p.scale : 0.f;
  if (masked && (qpos >= p.Lq || kpos >= p.Lk)) {
    pr = 0.f;
    pd = 0.f;
  }
  return pr;
}

// acc[NT tiles of 8 columns] = A.B^T over DP for this warp's 16 rows: A's
// rows from `arow` (ldmatrix addresses), B's NT * 8 rows from `b` + brow,
// both stored [rows, DP + 4].
template <int DP, int NT>
__device__ __forceinline__ void scores(float (*acc)[4], const float* arow,
                                       const float* b, int brow) {
  constexpr int LD = DP + 4;
  constexpr int G = NT < 4 ? NT : 4;
  static_assert(NT % G == 0 && G % 2 == 0, "tile shapes");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 8) {
    uint32_t raw[4], ah[4], al[4];
    ldsm4(raw, arow + d);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(raw[e], ah[e], al[e]);
#pragma unroll
    for (int j0 = 0; j0 < NT; j0 += G) {
      uint32_t bh[G][2], bl[G][2];
#pragma unroll
      for (int j = 0; j < G; j += 2) {
        // b0, b1 of n-tile j0 + j, then of j0 + j + 1
        ldsm4(raw, b + (8 * (j0 + j)) * LD + brow + d);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(raw[e], bh[j + e / 2][e % 2], bl[j + e / 2][e % 2]);
      }
      mma3<G>(acc + j0, ah, al, bh, bl);
    }
  }
}

// acc[NO tiles of 8 columns] += X.B for this warp's 16 rows, X in the C
// layout of `scores` (NK tiles of 8 contraction columns), B stored
// [NK * 8 rows, DP + 4] from column 0 of `b`.  Each group of GO output
// tiles is summed from zero over the NK tiles and folded into acc with
// one rounded add.
template <int DP, int NK, int NO>
__device__ __forceinline__ void accumulate(float (*acc)[4],
                                           const float (*x)[4],
                                           const float* b, int g, int t) {
  constexpr int LD = DP + 4;
  constexpr int GO = NO % 4 == 0 ? 4 : NO % 2 == 0 ? 2 : NO;
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += GO) {
    float part[GO][4];
#pragma unroll
    for (int n = 0; n < GO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      // contraction column 2t is A column t, 2t + 1 is A column t + 4
      uint32_t ah[4], al[4];
      split(__float_as_uint(x[j][0]), ah[0], al[0]);
      split(__float_as_uint(x[j][2]), ah[1], al[1]);
      split(__float_as_uint(x[j][1]), ah[2], al[2]);
      split(__float_as_uint(x[j][3]), ah[3], al[3]);
      const float* br = b + (8 * j + 2 * t) * LD + g + 8 * n0;
      uint32_t bh[GO][2], bl[GO][2];
#pragma unroll
      for (int n = 0; n < GO; ++n) {
        split(__float_as_uint(br[8 * n]), bh[n][0], bl[n][0]);
        split(__float_as_uint(br[LD + 8 * n]), bh[n][1], bl[n][1]);
      }
      mma3<GO>(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int n = 0; n < GO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// Store a warp's 16 x (8 * NO) accumulator from column c0 into rows
// [row0, row0 + 16) of out (row stride D), rows past n_rows and columns
// past D dropped.
template <int NO>
__device__ __forceinline__ void store_rows(float* out, const float (*acc)[4],
                                           long long row0, long long n_rows,
                                           int D, int c0, int g, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long row = row0 + g + 8 * r;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = c0 + 8 * n + 2 * t;
      if (c < D)
        *reinterpret_cast<float2*>(out + row * D + c) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// q rows a dq CTA owns: 16 a warp, or 16 a pair of warps
template <bool kPair>
__host__ __device__ constexpr int dq_rows() {
  return kPair ? kRows : 2 * kRows;
}

template <int DP, int BK, bool kPair>
__host__ __device__ constexpr int dq_smem_bytes() {
  // Q, dO resident; K, V in 2 stages; per pair Pd and dP - delta
  return static_cast<int>(sizeof(float)) *
         ((2 * dq_rows<kPair>() + 4 * BK) * (DP + 4) +
          (kPair ? 4 * 2 * BK * 16 : 0));
}

// One CTA owns dq_rows<kPair>() q rows: each warp 16 (kPair false), or
// each pair of warps 16, warp pair + 4 * role (kPair true).
template <int DP, int BK, bool kPair>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_f32tc_kernel(const Params p) {
  constexpr int LD = DP + 4;
  constexpr int BQ = dq_rows<kPair>();
  constexpr int NS = BK / 8;  // 8-key tiles of S and dP
  // 8-column tiles of dQ a warp owns: all, or half
  constexpr int NO = kPair ? DP / 16 : DP / 8;
  constexpr int NX = NS * 128;  // floats of one exchanged tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * LD;
  float* KVs = dOs + BQ * LD;  // stage s: K at 2s*BK*LD, then V
  float* X = KVs + 4 * BK * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = warp & 3;  // with kPair
  const int role = kPair ? warp >> 2 : 0;
  const int rw = kPair ? pair : warp;  // this warp's block of 16 rows
  const int g = lane >> 2, t = lane & 3;
  const long long bh = blockIdx.x;
  const int n_qt = static_cast<int>((p.Lq + BQ - 1) / BQ);
  if (flash::grid_tile() >= n_qt) return;  // past the last q tile
  const long long iq = n_qt - 1 - flash::grid_tile();  // heaviest first
  const long long b = bh / p.Hq, h = bh % p.Hq;
  const long long kvh = h / (p.Hq / p.Hkv);
  const long long q0 = iq * BQ;
  const long long qw0 = q0 + 16 * rw;  // this warp's first q row
  const int D = static_cast<int>(p.D);
  const float* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kvh * p.v_sh;
  const bool skip = skip_above_diagonal(p);

  long long n_kt = (p.Lk + BK - 1) / BK;
  if (skip) {
    const long long live = (q0 + BQ - 1) / BK + 1;
    if (live < n_kt) n_kt = live;
  }
  load_tile<BQ, DP>(Qs, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, p.Lq, D);
  load_tile<BQ, DP>(dOs, p.dout + b * p.do_sb + h * p.do_sh, p.do_sl, q0,
                    p.Lq, D);
  if (n_kt > 0) {
    load_tile<BK, DP>(KVs, kb, p.k_sl, 0, p.Lk, D);
    load_tile<BK, DP>(KVs + BK * LD, vb, p.v_sl, 0, p.Lk, D);
  }
  cp_async_commit();

  // the LSE and delta of this thread's rows g, g + 8
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long qpos = qw0 + g + 8 * r;
    const bool in = qpos < p.Lq;
    lse[r] = in ? p.lse[bh * p.Lq + qpos] : 0.f;
    delta[r] = in ? p.delta[bh * p.Lq + qpos] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int mi = lane >> 3, mr = lane & 7;
  const int arow = (16 * rw + mr + 8 * (mi & 1)) * LD + 4 * (mi >> 1);
  const int brow = (mr + 8 * (mi >> 1)) * LD + 4 * (mi & 1);
  float4* mine = reinterpret_cast<float4*>(X + (2 * pair + role) * NX) + lane;
  const float4* theirs =
      reinterpret_cast<const float4*>(X + (2 * pair + 1 - role) * NX) + lane;
  const int c0 = role * (8 * NO);  // this warp's first column of dQ

  for (long long kt = 0; kt < n_kt; ++kt) {
    float* Ks = KVs + (kt & 1) * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;
    if (kt + 1 < n_kt) {
      // the other stage was released by the last iteration's barrier
      float* Kn = KVs + ((kt + 1) & 1) * 2 * BK * LD;
      load_tile<BK, DP>(Kn, kb, p.k_sl, (kt + 1) * BK, p.Lk, D);
      load_tile<BK, DP>(Kn + BK * LD, vb, p.v_sl, (kt + 1) * BK, p.Lk, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const long long k0 = kt * BK;
    // a tile wholly above this warp's rows holds P = 0, dS = 0
    if (!(skip && k0 > qw0 + 15)) {
      const bool masked = (p.causal && k0 + BK - 1 > qw0) || p.has_window ||
                          k0 + BK > p.Lk;
      // element e of tile j: row qw0 + g + 8*(e/2), key k0 + 8j + 2t + e%2
      auto pd_of = [&](float sraw, int j, int e) {
        float pd;
        p_and_pd(p, sraw, lse[e >> 1], qw0 + g + 8 * (e >> 1),
                 k0 + 8 * j + 2 * t + (e & 1), masked, pd);
        return pd;
      };
      float s[NS][4];
      if constexpr (kPair) {
        // role 0: Pd from S; role 1: dP - delta; each hands its tile over
        scores<DP, NS>(s, (role ? dOs : Qs) + arow, role ? Vs : Ks, brow);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = role ? s[j][e] - delta[e >> 1] : pd_of(s[j][e], j, e);
          mine[32 * j] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
        }
        pair_sync(pair);
        // dS = Pd * (dP - delta), the same product in both warps
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float4 o = theirs[32 * j];
          s[j][0] *= o.x;
          s[j][1] *= o.y;
          s[j][2] *= o.z;
          s[j][3] *= o.w;
        }
      } else {
        float dp[NS][4];
        scores<DP, NS>(s, Qs + arow, Ks, brow);
        scores<DP, NS>(dp, dOs + arow, Vs, brow);
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = pd_of(s[j][e], j, e) * (dp[j][e] - delta[e >> 1]);
      }
      accumulate<DP, NS, NO>(acc, s, Ks + c0, g, t);
    }
    __syncthreads();  // every read of this stage and of X is done
  }
  cp_async_wait<0>();  // no copy outlives the block (n_kt == 0)
  store_rows<NO>(p.dq + bh * p.Lq * p.D, acc, qw0, p.Lq, D, c0, g, t);
}

template <int DP, int BQ>
__host__ __device__ constexpr int dkv_smem_bytes() {
  // K, V resident; Q, dO, LSE, delta in 2 stages; per pair Pd^T
  return static_cast<int>(sizeof(float)) *
         (2 * kRows * (DP + 4) + 2 * (2 * BQ * (DP + 4) + 2 * BQ) +
          4 * BQ * 16);
}

// One CTA owns 64 keys, a pair 16; warp pair + 4 * role.
template <int DP, int BQ>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_f32tc_kernel(const Params p) {
  constexpr int LD = DP + 4;
  constexpr int NT = BQ / 8;  // 8-row q tiles of S^T and dP^T
  constexpr int NO = DP / 8;  // 8-column tiles of dV (role 0), dK (role 1)
  constexpr int STAGE = 2 * BQ * LD + 2 * BQ;  // Q, dO, LSE, delta
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kRows * LD;
  float* stages = Vs + kRows * LD;
  float* X = stages + 2 * STAGE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pair = warp & 3, role = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const long long bh = blockIdx.x;
  const long long ik = flash::grid_tile();  // causal: low ones see most q
  if (ik * kRows >= p.Lk) return;  // past the last k tile
  const long long b = bh / p.Hq, h = bh % p.Hq;
  const long long kvh = h / (p.Hq / p.Hkv);
  const long long k0 = ik * kRows;
  const long long kw0 = k0 + 16 * pair;  // this pair's first key
  const int D = static_cast<int>(p.D);
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* lseb = p.lse + bh * p.Lq;
  const float* deltab = p.delta + bh * p.Lq;
  const bool skip = skip_above_diagonal(p);

  const long long n_qt = (p.Lq + BQ - 1) / BQ;
  const long long qt0 = skip ? k0 / BQ : 0;  // the first live q tile
  load_tile<kRows, DP>(Ks, p.k + b * p.k_sb + kvh * p.k_sh, p.k_sl, k0,
                       p.Lk, D);
  load_tile<kRows, DP>(Vs, p.v + b * p.v_sb + kvh * p.v_sh, p.v_sl, k0,
                       p.Lk, D);
  auto load_stage = [&](float* st, long long q0) {
    load_tile<BQ, DP>(st, qb, p.q_sl, q0, p.Lq, D);
    load_tile<BQ, DP>(st + BQ * LD, dob, p.do_sl, q0, p.Lq, D);
    load_vec<BQ>(st + 2 * BQ * LD, lseb, q0, p.Lq);
    load_vec<BQ>(st + 2 * BQ * LD + BQ, deltab, q0, p.Lq);
  };
  if (qt0 < n_qt) load_stage(stages, qt0 * BQ);
  cp_async_commit();

  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // ldmatrix row addresses: lane l gives row l % 8 of matrix l / 8
  const int mi = lane >> 3, mr = lane & 7;
  const float* arow = (role ? Vs : Ks) + (16 * pair + mr + 8 * (mi & 1)) * LD +
                      4 * (mi >> 1);
  const int brow = (mr + 8 * (mi >> 1)) * LD + 4 * (mi & 1);
  float4* xp = reinterpret_cast<float4*>(X + pair * NT * 128) + lane;

  for (long long qt = qt0; qt < n_qt; ++qt) {
    const float* Qs = stages + ((qt - qt0) & 1) * STAGE;
    const float* dOs = Qs + BQ * LD;
    const float* lse_s = dOs + BQ * LD;
    const float* delta_s = lse_s + BQ;
    if (qt + 1 < n_qt) {
      // the other stage was released by the last iteration's barrier
      load_stage(stages + ((qt + 1 - qt0) & 1) * STAGE, (qt + 1) * BQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const long long q0 = qt * BQ;
    // a tile wholly above this pair's keys holds P = 0, dS = 0
    if (!(skip && q0 + BQ - 1 < kw0)) {
      float s[NT][4];
      scores<DP, NT>(s, arow, role ? dOs : Qs, brow);
      const bool masked = (p.causal && q0 < kw0 + 15) || p.has_window ||
                          q0 + BQ > p.Lq || kw0 + 16 > p.Lk;
      // element e of tile j: key kw0 + g + 8*(e/2), q row q0 + 8j + 2t + e%2
      if (role == 0) {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float pd[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + 2 * t + (e & 1);
            s[j][e] = p_and_pd(p, s[j][e], lse_s[c], q0 + c,
                               kw0 + g + 8 * (e >> 1), masked, pd[e]);
          }
          xp[32 * j] = make_float4(pd[0], pd[1], pd[2], pd[3]);
        }
        pair_sync(pair);
      } else {
        pair_sync(pair);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float4 pd = xp[32 * j];
          const float2 dl = *reinterpret_cast<const float2*>(
              delta_s + 8 * j + 2 * t);
          s[j][0] = pd.x * (s[j][0] - dl.x);
          s[j][1] = pd.y * (s[j][1] - dl.y);
          s[j][2] = pd.z * (s[j][2] - dl.x);
          s[j][3] = pd.w * (s[j][3] - dl.y);
        }
      }
      // dV += P^T.dO (role 0), dK += dS^T.Q (role 1)
      accumulate<DP, NT, NO>(acc, s, role ? Qs : dOs, g, t);
    }
    __syncthreads();  // every read of this stage and of X is done
  }
  cp_async_wait<0>();  // no copy outlives the block (no live q tile)
  store_rows<NO>((role ? p.dk : p.dv) + bh * p.Lk * p.D, acc, kw0, p.Lk, D, 0,
                 g, t);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, long long tiles, long long bh,
                   const Params& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<flash::tile_grid(bh, tiles), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// BK: the k tile of dq, its warps paired at head_dim 256 alone; BQ: the q
// tile of dkv.
template <int DP, int BK, int BQ>
cudaError_t launch_one(bool dq, const Params& p, long long bh,
                       cudaStream_t st) {
  constexpr bool kPair = DP > 128;
  constexpr int kDq = dq_smem_bytes<DP, BK, kPair>();
  constexpr int kDkv = dkv_smem_bytes<DP, BQ>();
  static_assert(kDq <= 232448 && kDkv <= 232448,
                "over the 227 KB a block may use");
  constexpr int rows = dq_rows<kPair>();
  return dq ? launch(flash_dq_f32tc_kernel<DP, BK, kPair>, kDq,
                     (p.Lq + rows - 1) / rows, bh, p, st)
            : launch(flash_dkv_f32tc_kernel<DP, BQ>, kDkv,
                     (p.Lk + kRows - 1) / kRows, bh, p, st);
}

// Head dims pad up to the forward's six widths.
cudaError_t dispatch(bool dq, const Params& p, long long bh,
                     cudaStream_t st) {
  if (p.D <= 16) return launch_one<16, 32, 64>(dq, p, bh, st);
  if (p.D <= 32) return launch_one<32, 32, 64>(dq, p, bh, st);
  if (p.D <= 64) return launch_one<64, 32, 64>(dq, p, bh, st);
  if (p.D <= 80) return launch_one<80, 32, 64>(dq, p, bh, st);
  if (p.D <= 128) return launch_one<128, 32, 64>(dq, p, bh, st);
  if (p.D <= 256) return launch_one<256, 16, 16>(dq, p, bh, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, dout: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D), f32 with the given
// element strides (D contiguous, rows 16-byte aligned); lse and delta:
// (B, Hq, Lq) f32 contiguous.  dq: (B, Hq, Lq, D) f32 contiguous.  dk, dv:
// (B, Hq, Lk, D) f32 contiguous, one slice per q-head.  head_dim a
// multiple of 8 up to 256, Hq a multiple of Hkv: the Python wrapper checks
// all of it.
#define REPRO_FLASH_BWD_F32TC_SHAPE                                          \
  long long B, long long Hq, long long Hkv, long long Lq, long long Lk,      \
      long long D, long long q_sb, long long q_sh, long long q_sl,           \
      long long k_sb, long long k_sh, long long k_sl, long long v_sb,        \
      long long v_sh, long long v_sl, long long do_sb, long long do_sh,      \
      long long do_sl, int causal, int has_window, long long window,         \
      int has_softcap, float softcap, float scale, void *stream
#define REPRO_FLASH_BWD_F32TC_RUN(is_dq, dq_, dk_, dv_)                       \
  Params p{static_cast<const float*>(q), static_cast<const float*>(k),      \
           static_cast<const float*>(v), static_cast<const float*>(dout),   \
           static_cast<const float*>(lse), static_cast<const float*>(delta), \
           dq_, dk_, dv_, Hq, Hkv, Lq, Lk, D, q_sb, q_sh, q_sl, k_sb, k_sh,  \
           k_sl, v_sb, v_sh, v_sl, do_sb, do_sh, do_sl, window, scale,       \
           softcap, causal, has_window, has_softcap};                        \
  return static_cast<int>(                                                   \
      dispatch(is_dq, p, B * Hq, static_cast<cudaStream_t>(stream)))

extern "C" int repro_flash_dq_f32tc(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, REPRO_FLASH_BWD_F32TC_SHAPE) {
  REPRO_FLASH_BWD_F32TC_RUN(true, static_cast<float*>(dq), nullptr,
                            nullptr);
}

extern "C" int repro_flash_dkv_f32tc(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv,
                                     REPRO_FLASH_BWD_F32TC_SHAPE) {
  REPRO_FLASH_BWD_F32TC_RUN(false, nullptr, static_cast<float*>(dk),
                            static_cast<float*>(dv));
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
