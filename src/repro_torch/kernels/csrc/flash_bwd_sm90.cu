// flash_bwd_sm90: the flash-attention backward for bf16 inputs with head_dim
// up to 128, dQ and per-q-head dK, dV, on Hopper's tensor cores (wgmma) fed
// by TMA.
//
// Replaces the Pallas kernels `_dq_kernel` and `_dkv_kernel` of
// src/repro/kernels/flash_attention.py:146 and :166 (launched by `_bwd`),
// the attention backward of every layer on the flash route, for bf16 q, k,
// v, dO with head_dim padded to 16, 32, 64, 80 or 128; flash_bwd.cu keeps
// f32 inputs and wider heads.  Same function as flash_bwd.cu: the scores
// are recomputed in f32 (scale, then softcap c*tanh(s/c), then the masks:
// qpos >= kpos when causal, (qpos - kpos) < window whenever a window is
// set, one-sided even when non-causal, masked scores the finite -1e30),
// P = exp(s - LSE) from the forward's f32 LSE, dP = dO.V^T,
// dS = P * (dP - delta) * (1 - t^2 under softcap) * scale, zero where
// masked, delta = rowsum(dO * O) from the caller.  dQ = dS.K rounded once
// to bf16; dK = dS^T.Q and dV = P^T.dO per q-head in f32, which the caller
// sums over each GQA group in f32, so no two blocks write one output and
// the result does not depend on the schedule (no atomics).
//
// Bound on this card: operations.  A live (q, k) pair costs 6*D flops of
// useful work in dQ (Q.K^T, dO.V^T, dS.K) and 8*D in dK/dV (K.Q^T, V.dO^T,
// P^T.dO, dS^T.Q) against Q, K, V, dO, LSE, delta and the outputs read or
// written once, far above the ~300 flops/byte where device memory stops
// being the limit: the bf16 tensor cores' 989 TFLOP/s set the bound.  The
// split below makes this kernel's own work 8*D (dQ) and 12*D (dK/dV) a
// pair.
//
// Numerics.  Q.K^T and dO.V^T multiply bf16 inputs, so their products are
// exact in f32 and need no split.  P and dS are f32; each enters a tensor-
// core product as hi = bf16(x) and lo = bf16(x - hi), two wgmma on the same
// B tile, summed in f32: with x rounded once to bf16 (2^-9 of x) the f32
// dK and dV leave the tolerance they are held to (rtol 1e-3);
// hi + lo carries 16 bits.  exp is exp2f((s - LSE) * log2(e)) with the
// difference taken first: a row whose every key is masked has
// LSE = -1e30 and the reference's P = exp(-1e30 - LSE) = 1 there.
//
// Design.  Both kernels are shaped like flash_fwd_sm90.cu: one CTA with two
// consumer warpgroups and a producer warp (dq: 288 threads; dkv: a whole
// producer warpgroup, 384 threads, see below); the producer's
// TMA loads (4-D tensor maps over the strided (B, H, L, D) views, 128-byte
// swizzle, 64-column boxes, zero fill past Lq, Lk and D) keep a CTA's own
// 128-row tile resident and stream 64-row tiles of the other side through a
// ring of kStages stages, each guarded by a full and an empty mbarrier.
// The grid is flash_grid.cuh's (batch*head, tile), with the heaviest causal
// tiles first in launch order.
//   dkv:  a 128-row k tile; K and V resident; Q and dO tiles stream, with
//         their LSE and delta rows written into the stage by the producer
//         warp's lanes.  Each consumer warpgroup owns 64 k rows and, per q
//         tile, per 32-column half of it:
//           S^T = K.Q^T, dP^T = V.dO^T   wgmma m64n32k16, both operands
//                                        K-major in shared memory;
//           P^T, dS^T                    on the accumulator fragment;
//           dV += P^T.dO, dK += dS^T.Q   register-A wgmma m64nDk16, hi and
//                                        lo from the fragment, dO and Q read
//                                        MN-major (the same swizzled tile
//                                        that S^T read K-major).
//         32-column halves keep S^T and dP^T at 16 floats a thread beside
//         the 2 x D/2 of dK and dV (64 + 64 at D 128).  Even so the 168
//         registers a thread that three warps on each of the SM's four
//         register files allow spill at D 128, so the producer is a whole
//         warpgroup that lowers itself to 40 registers (setmaxnreg) and
//         the consumers rise to 232.  Tiles wholly above the causal diagonal
//         are skipped (unless a window <= 0 masks every key: then the
//         reference's P is 1 there).
//   dq:   a 128-row q tile; Q and dO resident, K and V tiles stream.  Each
//         warpgroup owns 64 q rows: S = Q.K^T and dP = dO.V^T by wgmma
//         m64n64k16, dS on the fragment, dQ += dS.K by register-A wgmma
//         (K read MN-major), dQ rounded once to bf16 and stored from
//         registers.  k tiles wholly above the diagonal hold dS = 0 and
//         are skipped.
// Rows and columns past Lq or Lk (TMA's zeros) get P = 0 and dS = 0
// explicitly; such rows are not stored.  exp2f and tanhf are the
// accurate ones (no fast math).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_grid.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBT = 128;                   // rows of a CTA's own tile
constexpr int kBS = 64;                    // rows of a streamed tile
constexpr int kStages = 3;                 // ring depth
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and one producer warp (dq)
constexpr int kDkvThreads = kConsumers + 128;  // a producer warpgroup (dkv)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // dkv, a thread
constexpr int kRowBytes = 128;             // 64 bf16 columns, one box
constexpr int kBoxBytes = 64 * kRowBytes;  // one 64-row box
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeFailed = 0x10000;  // returned when TMA maps fail

struct Params {
  const float* lse;    // (B*Hq, Lq)
  const float* delta;  // (B*Hq, Lq)
  __nv_bfloat16* dq;   // (B*Hq, Lq, D)
  float* dk;           // (B*Hq, Lk, D), per q-head
  float* dv;           // (B*Hq, Lk, D), per q-head
  int Hq, Hkv, Lq, Lk, D, window;
  float scale, softcap;
  int causal, has_window, has_softcap;
};

// Shared memory: two resident tiles (DB boxes of 128 rows each), two rings
// (DB boxes of 64 rows a stage), `rows` floats a stage, the barriers; plus
// 1024 bytes of alignment.
__host__ __device__ constexpr int smem_bytes(int DB, int rows) {
  return 2 * DB * kBT * kRowBytes + 2 * kStages * DB * kBoxBytes +
         kStages * rows * 4 + 8 * (1 + 2 * kStages) + 1024;
}

// The reference's `_p_ds` for one score: `s` the raw Q.K product, `dp`
// dO.V, the q row's LSE and delta, `keep` false where masked.  Returns P
// and sets `ds`.
__device__ __forceinline__ float p_ds(const Params& p, float s, float dp,
                                      float lse, float delta, bool keep,
                                      float& ds) {
  float x = s * p.scale;
  float dcap = 1.f;
  if (p.has_softcap) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    dcap = 1.f - t * t;
  }
  if (!keep) x = kNeg;
  const float pr = exp2f((x - lse) * kLog2e);
  ds = keep ? pr * (dp - delta) * dcap * p.scale : 0.f;
  return pr;
}

__device__ __forceinline__ bool keep_pair(const Params& p, int qpos,
                                          int kpos) {
  bool keep = true;
  if (p.causal) keep = keep && qpos >= kpos;
  if (p.has_window) keep = keep && (qpos - kpos) < p.window;
  return keep;
}

// Causal tiles above the diagonal hold P = 0 and dS = 0, unless a window
// of 0 or less masks every key (then the reference's P is 1 everywhere).
__device__ __forceinline__ bool skip_above_diagonal(const Params& p) {
  return p.causal && !(p.has_window && p.window <= 0);
}

template <int DP>
__global__ void __launch_bounds__(kDkvThreads, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap,
                          const Params p) {
  constexpr int DB = (DP + 63) / 64;  // 64-column boxes per row
  constexpr int NA = DP / 2;          // dK, dV accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + DB * kBT * kRowBytes;
  const uint32_t sQ = sV + DB * kBT * kRowBytes;
  const uint32_t sDO = sQ + kStages * DB * kBoxBytes;
  const uint32_t sRows = sDO + kStages * DB * kBoxBytes;  // LSE, delta
  const uint32_t kv_full = sRows + kStages * 2 * kBS * 4;
  const uint32_t full = kv_full + 8;           // + 8 * stage
  const uint32_t empty = full + 8 * kStages;   // + 8 * stage
  float* rows = reinterpret_cast<float*>(smem_raw + (sRows - base));

  const int bh = blockIdx.x;
  // past the last k tile
  if (static_cast<long long>(flash::grid_tile()) * kBT >= p.Lk) return;
  // low k tiles see the most q rows
  const int k0 = flash::grid_tile() * kBT;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const bool skip = skip_above_diagonal(p);
  const int n_qt = (p.Lq + kBS - 1) / kBS;
  const int qt0 = skip ? min(k0 / kBS, n_qt) : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 32);                // the producer's lanes
      mbar_init(empty + 8 * s, kConsumers / 32);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    const int lane = threadIdx.x - kConsumers;
    if (lane >= 32) return;  // one warp loads
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * DB * kBT * kRowBytes);
      for (int rb = 0; rb < kBT / 64; ++rb)
        for (int cb = 0; cb < DB; ++cb) {
          const uint32_t off = cb * kBT * kRowBytes + rb * kBoxBytes;
          tma_load_4d(sK + off, &kmap, kv_full, 64 * cb, k0 + 64 * rb, kvh,
                      b);
          tma_load_4d(sV + off, &vmap, kv_full, 64 * cb, k0 + 64 * rb, kvh,
                      b);
        }
    }
    const float* lse = p.lse + static_cast<long long>(bh) * p.Lq;
    const float* delta = p.delta + static_cast<long long>(bh) * p.Lq;
    for (int qt = qt0, i = 0; qt < n_qt; ++qt, ++i) {
      const int s = i % kStages;
      mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
      const int q0 = qt * kBS;
      float* row = rows + s * 2 * kBS;
      for (int r = lane; r < kBS; r += 32) {
        const int q = q0 + r;
        row[r] = q < p.Lq ? lse[q] : 0.f;
        row[kBS + r] = q < p.Lq ? delta[q] : 0.f;
      }
      if (lane == 0) {  // arrives with the bytes TMA will complete
        mbar_expect_tx(full + 8 * s, 2 * DB * kBoxBytes);
        for (int cb = 0; cb < DB; ++cb) {
          tma_load_4d(sQ + (s * DB + cb) * kBoxBytes, &qmap, full + 8 * s,
                      64 * cb, q0, h, b);
          tma_load_4d(sDO + (s * DB + cb) * kBoxBytes, &domap, full + 8 * s,
                      64 * cb, q0, h, b);
        }
      } else {
        mbar_arrive(full + 8 * s);  // releases this lane's row writes
      }
    }
    return;
  }

  // -- a consumer warpgroup: k rows [kw, kw + 64) -----------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int kw = k0 + 64 * wg;
  // this thread's k rows r0 and r0 + 8; its q columns 8j + c0 and
  // 8j + c0 + 1 of each 32-column half
  const int r0 = kw + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);

  float dk[NA], dv[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  const uint64_t k_desc = smem_desc(sK + wg * kBoxBytes, 16, 1024);
  const uint64_t v_desc = smem_desc(sV + wg * kBoxBytes, 16, 1024);

  mbar_wait(kv_full, 0);
  for (int qt = qt0, i = 0; qt < n_qt; ++qt, ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const int q0 = qt * kBS;
    // a tile wholly above this warpgroup's diagonal is all zeros for it
    if (!(skip && q0 + kBS - 1 < kw)) {
      const float* row = rows + s * 2 * kBS;
      const uint32_t sq = sQ + s * DB * kBoxBytes;
      const uint32_t sdo = sDO + s * DB * kBoxBytes;
      const uint64_t q_kmaj = smem_desc(sq, 16, 1024);
      const uint64_t do_kmaj = smem_desc(sdo, 16, 1024);
      const uint64_t q_mnmaj = smem_desc(sq, kBoxBytes, 1024);
      const uint64_t do_mnmaj = smem_desc(sdo, kBoxBytes, 1024);
#pragma unroll 1
      for (int hq = 0; hq < 2; ++hq) {
        const int qh = q0 + 32 * hq;
        float st[16], dpt[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          // 16 columns of one box: 32 bytes along the swizzled row
          const uint32_t aoff = (kk / 4) * kBT * kRowBytes + (kk % 4) * 32;
          const uint32_t boff =
              (kk / 4) * kBoxBytes + hq * 32 * kRowBytes + (kk % 4) * 32;
          wgmma_ss_n32(st, k_desc + (aoff >> 4), q_kmaj + (boff >> 4),
                       kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          const uint32_t aoff = (kk / 4) * kBT * kRowBytes + (kk % 4) * 32;
          const uint32_t boff =
              (kk / 4) * kBoxBytes + hq * 32 * kRowBytes + (kk % 4) * 32;
          wgmma_ss_n32(dpt, v_desc + (aoff >> 4), do_kmaj + (boff >> 4),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        // st[i]: k row r0 + 8 * ((i / 2) % 2), q column
        // qh + 8 * (i / 4) + c0 + i % 2
        const bool edge = qh + 31 >= p.Lq || kw + 63 >= p.Lk ||
                          (p.causal && qh < kw + 63) ||
                          (p.has_window && qh + 31 - kw >= p.window);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int cq = 32 * hq + 8 * (e / 4) + c0 + e % 2;
          const int qpos = q0 + cq;
          const int kpos = r0 + 8 * ((e / 2) % 2);
          const bool keep = !edge || keep_pair(p, qpos, kpos);
          float ds;
          float pr = p_ds(p, st[e], dpt[e], row[cq], row[kBS + cq], keep, ds);
          if (edge && (qpos >= p.Lq || kpos >= p.Lk)) {
            pr = 0.f;
            ds = 0.f;
          }
          st[e] = pr;
          dpt[e] = ds;
        }

        // 16 q columns per step: accumulator blocks 2t and 2t + 1 are
        // wgmma's A fragment (rows r0, r0 + 8; columns c0, c0 + 1, c0 + 8,
        // c0 + 9), split into hi and lo
        uint32_t ph[2][4], pl[2][4], sh[2][4], sl[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            split_pair(st[8 * t + 2 * a], st[8 * t + 2 * a + 1], ph[t][a],
                       pl[t][a]);
            split_pair(dpt[8 * t + 2 * a], dpt[8 * t + 2 * a + 1], sh[t][a],
                       sl[t][a]);
          }
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const uint32_t off = ((32 * hq + 16 * t) * kRowBytes) >> 4;
          wgmma_rs(dv, ph[t], do_mnmaj + off);
          wgmma_rs(dv, pl[t], do_mnmaj + off);
          wgmma_rs(dk, sh[t], q_mnmaj + off);
          wgmma_rs(dk, sl[t], q_mnmaj + off);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with s
  }

  const long long out0 = static_cast<long long>(bh) * p.Lk * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = r0 + 8 * r;
    if (kpos >= p.Lk) continue;
    float* dkr = p.dk + out0 + static_cast<long long>(kpos) * p.D;
    float* dvr = p.dv + out0 + static_cast<long long>(kpos) * p.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + c0;
      if (c < p.D) {
        *reinterpret_cast<float2*>(dkr + c) =
            make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(dvr + c) =
            make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap domap,
                         const Params p) {
  constexpr int DB = (DP + 63) / 64;  // 64-column boxes per row
  constexpr int NA = DP / 2;          // dQ accumulator floats a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sDO = sQ + DB * kBT * kRowBytes;
  const uint32_t sK = sDO + DB * kBT * kRowBytes;
  const uint32_t sV = sK + kStages * DB * kBoxBytes;
  const uint32_t qd_full = sV + kStages * DB * kBoxBytes;
  const uint32_t full = qd_full + 8;           // + 8 * stage
  const uint32_t empty = full + 8 * kStages;   // + 8 * stage

  const int bh = blockIdx.x;
  const int n_qt = (p.Lq + kBT - 1) / kBT;
  if (flash::grid_tile() >= n_qt) return;  // past the last q tile
  const int iq = n_qt - 1 - flash::grid_tile();
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = iq * kBT;
  // k tiles wholly above the diagonal hold dS = 0 (masked) for every row
  int n_kt = (p.Lk + kBS - 1) / kBS;
  if (p.causal) n_kt = min(n_kt, (q0 + kBT - 1) / kBS + 1);

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qd_full, 2 * DB * kBT * kRowBytes);
      for (int rb = 0; rb < kBT / 64; ++rb)
        for (int cb = 0; cb < DB; ++cb) {
          const uint32_t off = cb * kBT * kRowBytes + rb * kBoxBytes;
          tma_load_4d(sQ + off, &qmap, qd_full, 64 * cb, q0 + 64 * rb, h, b);
          tma_load_4d(sDO + off, &domap, qd_full, 64 * cb, q0 + 64 * rb, h,
                      b);
        }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * DB * kBoxBytes);
        for (int cb = 0; cb < DB; ++cb) {
          tma_load_4d(sK + (s * DB + cb) * kBoxBytes, &kmap, full + 8 * s,
                      64 * cb, kt * kBS, kvh, b);
          tma_load_4d(sV + (s * DB + cb) * kBoxBytes, &vmap, full + 8 * s,
                      64 * cb, kt * kBS, kvh, b);
        }
      }
    }
    return;
  }

  // -- a consumer warpgroup: q rows [wq, wq + 64) -----------------------------
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wq = q0 + 64 * wg;
  // this thread's rows r0 and r0 + 8; its columns 8j + c0 and 8j + c0 + 1
  const int r0 = wq + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  // tiles past this warpgroup's diagonal are all masked for it
  const int n_mine = p.causal ? min(n_kt, (wq + 63) / kBS + 1) : n_kt;

  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r0 + 8 * r;
    const long long at = static_cast<long long>(bh) * p.Lq + qpos;
    lse[r] = qpos < p.Lq ? p.lse[at] : 0.f;
    delta[r] = qpos < p.Lq ? p.delta[at] : 0.f;
  }
  float dq[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) dq[i] = 0.f;
  const uint64_t q_desc = smem_desc(sQ + wg * kBoxBytes, 16, 1024);
  const uint64_t do_desc = smem_desc(sDO + wg * kBoxBytes, 16, 1024);

  mbar_wait(qd_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    if (kt < n_mine) {
      const int k0 = kt * kBS;
      const uint32_t sk = sK + s * DB * kBoxBytes;
      const uint64_t k_kmaj = smem_desc(sk, 16, 1024);
      const uint64_t v_kmaj = smem_desc(sV + s * DB * kBoxBytes, 16, 1024);
      const uint64_t k_mnmaj = smem_desc(sk, kBoxBytes, 1024);
      float sc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // 16 columns of one box: 32 bytes along the swizzled row
        const uint32_t aoff = (kk / 4) * kBT * kRowBytes + (kk % 4) * 32;
        const uint32_t boff = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n64(sc, q_desc + (aoff >> 4), k_kmaj + (boff >> 4), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t aoff = (kk / 4) * kBT * kRowBytes + (kk % 4) * 32;
        const uint32_t boff = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_ss_n64(dp, do_desc + (aoff >> 4), v_kmaj + (boff >> 4),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // sc[i]: row r0 + 8 * ((i / 2) % 2), column k0 + 8 * (i / 4) + c0 + i % 2
      const bool edge = wq + 63 >= p.Lq || k0 + kBS > p.Lk ||
                        (p.causal && k0 + kBS - 1 > wq) ||
                        (p.has_window && wq + 63 - k0 >= p.window);
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e / 2) % 2;
        const int qpos = r0 + 8 * r;
        const int kpos = k0 + 8 * (e / 4) + c0 + e % 2;
        const bool keep = !edge || keep_pair(p, qpos, kpos);
        float ds;
        p_ds(p, sc[e], dp[e], lse[r], delta[r], keep, ds);
        if (edge && (qpos >= p.Lq || kpos >= p.Lk)) ds = 0.f;
        dp[e] = ds;
      }

      // 16 keys per step: accumulator blocks 2t and 2t + 1 are wgmma's A
      // fragment, split into hi and lo; K read MN-major
      uint32_t hi[kBS / 16][4], lo[kBS / 16][4];
#pragma unroll
      for (int t = 0; t < kBS / 16; ++t)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split_pair(dp[8 * t + 2 * a], dp[8 * t + 2 * a + 1], hi[t][a],
                     lo[t][a]);
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kBS / 16; ++t) {
        const uint64_t d = k_mnmaj + ((t * 16 * kRowBytes) >> 4);
        wgmma_rs(dq, hi[t], d);
        wgmma_rs(dq, lo[t], d);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with s
  }

  __nv_bfloat16* out = p.dq + static_cast<long long>(bh) * p.Lq * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r0 + 8 * r;
    if (qpos >= p.Lq) continue;
    __nv_bfloat16* orow = out + static_cast<long long>(qpos) * p.D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + c0;
      if (c < p.D)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
    }
  }
}

struct Maps {
  CUtensorMap q, k, v, dout;
};

template <typename Kernel>
cudaError_t launch(Kernel kernel, int threads, int smem, long long rows,
                   const Maps& m, const Params& p, long long bh,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<flash::tile_grid(bh, (rows + kBT - 1) / kBT), threads, smem,
           stream>>>(m.q, m.k, m.v, m.dout, p);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_one(bool dq, const Maps& m, const Params& p, long long bh,
                       cudaStream_t st) {
  constexpr int DB = (DP + 63) / 64;
  return dq ? launch(flash_dq_sm90_kernel<DP>, kThreads, smem_bytes(DB, 0),
                     p.Lq, m, p, bh, st)
            : launch(flash_dkv_sm90_kernel<DP>, kDkvThreads,
                     smem_bytes(DB, 2 * kBS), p.Lk, m, p, bh, st);
}

// Head dims pad up to the forward's widths: 16, 32, 64, 80, 128.
int run(bool dq, const void* q, const void* k, const void* v,
        const void* dout, Params& p, long long B, long long q_sb,
        long long q_sh, long long q_sl, long long k_sb, long long k_sh,
        long long k_sl, long long v_sb, long long v_sh, long long v_sl,
        long long do_sb, long long do_sh, long long do_sl, void* stream) {
  Maps m;
  if (!make_tile_map(&m.q, q, B, p.Hq, p.Lq, p.D, q_sb, q_sh, q_sl) ||
      !make_tile_map(&m.k, k, B, p.Hkv, p.Lk, p.D, k_sb, k_sh, k_sl) ||
      !make_tile_map(&m.v, v, B, p.Hkv, p.Lk, p.D, v_sb, v_sh, v_sl) ||
      !make_tile_map(&m.dout, dout, B, p.Hq, p.Lq, p.D, do_sb, do_sh,
                     do_sl))
    return kEncodeFailed;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long bh = B * p.Hq;
  cudaError_t err;
  if (p.D <= 16) err = launch_one<16>(dq, m, p, bh, st);
  else if (p.D <= 32) err = launch_one<32>(dq, m, p, bh, st);
  else if (p.D <= 64) err = launch_one<64>(dq, m, p, bh, st);
  else if (p.D <= 80) err = launch_one<80>(dq, m, p, bh, st);
  else if (p.D <= 128) err = launch_one<128>(dq, m, p, bh, st);
  else err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

Params make_params(const void* lse, const void* delta, void* dq, void* dk,
                   void* dv, long long Hq, long long Hkv, long long Lq,
                   long long Lk, long long D, int causal, int has_window,
                   long long window, int has_softcap, float softcap,
                   float scale) {
  // |qpos - kpos| < 2^31: a wider window masks nothing more
  const long long max_window = 1LL << 30;
  const long long w = window < max_window ? window : max_window;
  return Params{static_cast<const float*>(lse),
                static_cast<const float*>(delta),
                static_cast<__nv_bfloat16*>(dq),
                static_cast<float*>(dk),
                static_cast<float*>(dv),
                static_cast<int>(Hq),
                static_cast<int>(Hkv),
                static_cast<int>(Lq),
                static_cast<int>(Lk),
                static_cast<int>(D),
                static_cast<int>(w > -max_window ? w : -max_window),
                scale,
                softcap,
                causal,
                has_window,
                has_softcap};
}

}  // namespace

// q, dout: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D), bf16, each with the given
// element strides (D contiguous; strides multiples of 8 and the bases
// 16-byte aligned, as TMA needs); lse and delta: (B, Hq, Lq) f32
// contiguous.  dq: (B, Hq, Lq, D) contiguous bf16.  dk, dv: (B, Hq, Lk, D)
// f32 contiguous, one slice per q-head.  head_dim a multiple of 8 up to
// 128, Hq a multiple of Hkv: the Python wrapper checks all of it.
#define REPRO_FLASH_BWD_SM90_SHAPE                                            \
  long long B, long long Hq, long long Hkv, long long Lq, long long Lk,      \
      long long D, long long q_sb, long long q_sh, long long q_sl,           \
      long long k_sb, long long k_sh, long long k_sl, long long v_sb,        \
      long long v_sh, long long v_sl, long long do_sb, long long do_sh,      \
      long long do_sl, int causal, int has_window, long long window,         \
      int has_softcap, float softcap, float scale, void *stream
#define REPRO_FLASH_BWD_SM90_RUN(dq_)                                         \
  run(dq_, q, k, v, dout, p, B, q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb,    \
      v_sh, v_sl, do_sb, do_sh, do_sl, stream)

extern "C" int repro_flash_dq_sm90(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, REPRO_FLASH_BWD_SM90_SHAPE) {
  Params p = make_params(lse, delta, dq, nullptr, nullptr, Hq, Hkv, Lq, Lk,
                         D, causal, has_window, window, has_softcap, softcap,
                         scale);
  return REPRO_FLASH_BWD_SM90_RUN(true);
}

extern "C" int repro_flash_dkv_sm90(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv,
                                    REPRO_FLASH_BWD_SM90_SHAPE) {
  Params p = make_params(lse, delta, nullptr, dk, dv, Hq, Hkv, Lq, Lk, D,
                         causal, has_window, window, has_softcap, softcap,
                         scale);
  return REPRO_FLASH_BWD_SM90_RUN(false);
}

extern "C" const char* repro_error_string(int code) {
  if (code == kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a tensor map (or is "
           "unavailable)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
