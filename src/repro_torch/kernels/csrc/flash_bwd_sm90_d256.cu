// flash_bwd_sm90_d256: the flash-attention backward for bf16 inputs with
// head_dim above 128 and up to 256, dQ and per-q-head dK, dV, on Hopper's
// tensor cores (wgmma) fed by TMA.
//
// Replaces the Pallas kernels `_dq_kernel` and `_dkv_kernel` of
// src/repro/kernels/flash_attention.py:146 and :166 (launched by `_bwd` at
// :190), the attention backward of every layer on the flash route, for
// bf16 q, k, v, dO with 128 < head_dim <= 256, padded to 256 (gemma2-2b's
// 256 runs unpadded); flash_bwd_sm90.cu takes the narrower bf16 heads and
// flash_bwd.cu f32 inputs.  Same function as both: the scores are
// recomputed in f32 (scale, then the softcap c*tanh(s/c), then the masks:
// qpos >= kpos when causal, (qpos - kpos) < window whenever a window is
// set, one-sided even when non-causal, masked scores the finite -1e30),
// P = exp(s - LSE) from the forward's f32 LSE, dP = dO.V^T,
// dS = P * (dP - delta) * (1 - t^2 under the softcap) * scale, zero where
// masked, delta = rowsum(dO * O) from the caller.  dQ = dS.K rounded once
// to bf16; dK = dS^T.Q and dV = P^T.dO per q-head in f32, which the caller
// sums over each GQA group in f32, so no two blocks write one output and
// the result does not depend on the schedule (no atomics).
//
// Bound on this card: operations.  A live (q, k) pair costs 6*D flops of
// useful work in dQ and 8*D in dK/dV against Q, K, V, dO, LSE, delta and
// the outputs read or written once, far above the ~300 flops/byte where
// device memory stops being the limit: the bf16 tensor cores' 989 TFLOP/s
// set the bound.  The designs below make this file's own work 8*D (dq)
// and 16*D (dkv) flops a pair.
//
// Numerics, as flash_bwd_sm90.cu: Q.K^T and dO.V^T multiply bf16 inputs
// (exact products, f32 sums); P and dS enter the tensor cores as
// hi = bf16(x) and lo = bf16(x - hi), two wgmma on the same B tile summed
// in f32 (one bf16 P or dS leaves the f32 dK, dV beyond rtol 1e-3); exp is
// exp2f((s - LSE) * log2(e)) with the difference taken first, so a row
// whose every key is masked (LSE = -1e30) keeps the reference's P = 1.
// The softcap is flash_fwd_sm90_d256.cu's form, t = 1 - 2 / (exp(2x/c) + 1)
// from exp2f and a fast division (tanhf took a third longer in that
// kernel), x = c*t and 1 - t^2 from the same t.
//
// Design.  flash_bwd_sm90.cu does not fit at D 256: its dK and dV for 64
// k rows would take 256 f32 registers a thread (255 is the ceiling), and
// its 128-row resident tiles beside a 3-stage ring of 64-row tiles would
// need far more than the 227 KB of shared memory a block may use.  Both
// kernels here run 384 threads: two consumer warpgroups and a producer
// warpgroup that lowers itself to kProducerRegs registers a thread
// (setmaxnreg) so that the consumers can rise to kConsumerRegs.  The
// producer's TMA loads (4-D tensor maps over the strided (B, H, L, D)
// views, 128-byte swizzle, 64-column boxes, zero fill past Lq, Lk and D,
// which pads head dims such as 136 or 200 to 256) keep a CTA's own tile
// resident and stream the other side through a ring of kStages stages,
// each guarded by a full and an empty mbarrier.  The grid is
// flash_grid.cuh's (batch*head, tile), the heaviest causal tiles first.
//   dq:   one CTA per 128-row q tile; Q and dO resident (64 KB each), K and
//         V through the ring in 32-row tiles (16 KB each a stage; 64-row
//         tiles would not fit beside the resident ones): 193 KB.  Each
//         consumer warpgroup owns 64 q rows and, per k tile:
//           S = Q.K^T, dP = dO.V^T   wgmma m64n32k16 over 16 k-steps,
//                                    both operands K-major in shared memory;
//           dS                       on the accumulator fragment;
//           dQ += dS.K               register-A wgmma m64n128k16 into each
//                                    128-column half of dQ, hi and lo, K
//                                    read MN-major from the same tile.
//         A thread holds dQ (128 f32), S and dP for 32 keys (16 + 16) and
//         dS's halves (16).  k tiles wholly above the causal diagonal hold
//         dS = 0 and are never loaded.
//   dkv:  one CTA per 64-row k tile; K and V resident (32 KB each), Q and
//         dO through the ring in 64-row tiles (32 KB each a stage), with
//         their LSE and delta rows written into the stage by the producer
//         warp's lanes: 194 KB.  The two consumer warpgroups split D: each
//         owns one 128-column half of dK and of dV (64 + 64 f32 a thread)
//         and recomputes S^T and dP^T over the full D for all 64 k rows,
//         per q tile in two 32-column halves:
//           S^T = K.Q^T, dP^T = V.dO^T   wgmma m64n32k16, K-major;
//           P^T, dS^T                    on the accumulator fragment;
//           dV += P^T.dO, dK += dS^T.Q   register-A wgmma m64n128k16 on
//                                        this warpgroup's 128 columns of
//                                        dO and Q, read MN-major.
//         The recompute costs 16*D flops a pair where 12*D would do, and
//         needs no hand-off of P and dS between the warpgroups.  q tiles
//         wholly above the causal diagonal are skipped (unless a window
//         <= 0 masks every key: then the reference's P is 1 there).
// Rows and columns past Lq or Lk (TMA's zeros) get P = 0 and dS = 0
// explicitly; such rows are not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_grid.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kDP = 256;                    // padded head dim
constexpr int kDB = kDP / 64;               // 64-column boxes per row
constexpr int kStages = 2;                  // ring depth, both kernels
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // a thread
constexpr int kRowBytes = 128;              // 64 bf16 columns, one box row
constexpr int kQRows = 128;                 // dq: rows of the q tile
constexpr int kQKeys = 32;                  // dq: rows of a K, V tile
constexpr int kKRows = 64;                  // dkv: rows of the k tile
constexpr int kKQRows = 64;                 // dkv: rows of a Q, dO tile
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
  float cap2;          // 2 * log2(e) / softcap
  int causal, has_window, has_softcap;
};

// Shared memory, plus 1024 bytes of alignment.  dq: Q and dO (kDB boxes of
// 128 rows each), the K and V rings (kDB boxes of 32 rows a stage), the
// barriers.  dkv: K and V (kDB boxes of 64 rows), the Q and dO rings (kDB
// boxes of 64 rows a stage), LSE and delta rows a stage, the barriers.
constexpr int kDqSmem = 2 * kDB * kQRows * kRowBytes +
                        2 * kStages * kDB * kQKeys * kRowBytes +
                        8 * (1 + 2 * kStages) + 1024;
constexpr int kDkvSmem = 2 * kDB * kKRows * kRowBytes +
                         2 * kStages * kDB * kKQRows * kRowBytes +
                         kStages * 2 * kKQRows * 4 + 8 * (1 + 2 * kStages) +
                         1024;

// The reference's `_p_ds` for one score: `s` the raw Q.K product, `dp`
// dO.V, the q row's LSE and delta, `keep` false where masked.  Returns P
// and sets `ds`.
__device__ __forceinline__ float p_ds(const Params& p, float s, float dp,
                                      float lse, float delta, bool keep,
                                      float& ds) {
  float x = s * p.scale;
  float dcap = 1.f;
  if (p.has_softcap) {
    const float e = exp2f(fminf(x * p.cap2, 64.f));
    const float t = 1.f - __fdividef(2.f, e + 1.f);
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

__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_sm90_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const __grid_constant__ CUtensorMap domap,
                               const Params p) {
  constexpr int kBox = 64 * kRowBytes;  // one 64-row box (K, V, Q, dO)
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + kDB * kBox;
  const uint32_t sQ = sV + kDB * kBox;
  const uint32_t sDO = sQ + kStages * kDB * kBox;
  const uint32_t sRows = sDO + kStages * kDB * kBox;  // LSE, delta
  const uint32_t kv_full = sRows + kStages * 2 * kKQRows * 4;
  const uint32_t full = kv_full + 8;           // + 8 * stage
  const uint32_t empty = full + 8 * kStages;   // + 8 * stage
  float* rows = reinterpret_cast<float*>(smem_raw + (sRows - base));

  const int bh = blockIdx.x;
  // past the last k tile
  if (static_cast<long long>(flash::grid_tile()) * kKRows >= p.Lk) return;
  // low k tiles see the most q rows
  const int k0 = flash::grid_tile() * kKRows;
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  // causal q tiles wholly above the diagonal hold P = 0 and dS = 0, unless
  // a window of 0 or less masks every key (then the reference's P is 1)
  const bool skip = p.causal && !(p.has_window && p.window <= 0);
  const int n_qt = (p.Lq + kKQRows - 1) / kKQRows;
  const int qt0 = skip ? min(k0 / kKQRows, n_qt) : 0;

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
      mbar_expect_tx(kv_full, 2 * kDB * kBox);
      for (int cb = 0; cb < kDB; ++cb) {
        tma_load_4d(sK + cb * kBox, &kmap, kv_full, 64 * cb, k0, kvh, b);
        tma_load_4d(sV + cb * kBox, &vmap, kv_full, 64 * cb, k0, kvh, b);
      }
    }
    const float* lse = p.lse + static_cast<long long>(bh) * p.Lq;
    const float* delta = p.delta + static_cast<long long>(bh) * p.Lq;
    for (int qt = qt0, i = 0; qt < n_qt; ++qt, ++i) {
      const int s = i % kStages;
      mbar_wait(empty + 8 * s, ((i / kStages) & 1) ^ 1);
      const int q0 = qt * kKQRows;
      float* row = rows + s * 2 * kKQRows;
      for (int r = lane; r < kKQRows; r += 32) {
        const int q = q0 + r;
        row[r] = q < p.Lq ? lse[q] : 0.f;
        row[kKQRows + r] = q < p.Lq ? delta[q] : 0.f;
      }
      if (lane == 0) {  // arrives with the bytes TMA will complete
        mbar_expect_tx(full + 8 * s, 2 * kDB * kBox);
        for (int cb = 0; cb < kDB; ++cb) {
          tma_load_4d(sQ + (s * kDB + cb) * kBox, &qmap, full + 8 * s,
                      64 * cb, q0, h, b);
          tma_load_4d(sDO + (s * kDB + cb) * kBox, &domap, full + 8 * s,
                      64 * cb, q0, h, b);
        }
      } else {
        mbar_arrive(full + 8 * s);  // releases this lane's row writes
      }
    }
    return;
  }

  // -- a consumer warpgroup: columns [128 wg, 128 wg + 128) of dK and dV ---
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  // this thread's k rows r0 and r0 + 8; its q columns 8j + c0 and
  // 8j + c0 + 1 of each 32-column half
  const int r0 = k0 + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  const uint64_t k_desc = smem_desc(sK, 16, 1024);
  const uint64_t v_desc = smem_desc(sV, 16, 1024);

  mbar_wait(kv_full, 0);
  for (int qt = qt0, i = 0; qt < n_qt; ++qt, ++i) {
    const int s = i % kStages;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    const int q0 = qt * kKQRows;
    const float* row = rows + s * 2 * kKQRows;
    const uint32_t sq = sQ + s * kDB * kBox;
    const uint32_t sdo = sDO + s * kDB * kBox;
    const uint64_t q_kmaj = smem_desc(sq, 16, 1024);
    const uint64_t do_kmaj = smem_desc(sdo, 16, 1024);
    // this warpgroup's two boxes of Q and dO, MN-major: the next 64-column
    // box is kBox on
    const uint64_t q_mnmaj = smem_desc(sq + 2 * wg * kBox, kBox, 1024);
    const uint64_t do_mnmaj = smem_desc(sdo + 2 * wg * kBox, kBox, 1024);
#pragma unroll 1
    for (int hq = 0; hq < 2; ++hq) {
      const int qh = q0 + 32 * hq;
      float st[16], dpt[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk) {
        // 16 columns of one box: 32 bytes along the swizzled row
        const uint32_t aoff = (kk / 4) * kBox + (kk % 4) * 32;
        const uint32_t boff =
            (kk / 4) * kBox + hq * 32 * kRowBytes + (kk % 4) * 32;
        wgmma_ss_n32(st, k_desc + (aoff >> 4), q_kmaj + (boff >> 4), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk) {
        const uint32_t aoff = (kk / 4) * kBox + (kk % 4) * 32;
        const uint32_t boff =
            (kk / 4) * kBox + hq * 32 * kRowBytes + (kk % 4) * 32;
        wgmma_ss_n32(dpt, v_desc + (aoff >> 4), do_kmaj + (boff >> 4),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // st[i]: k row r0 + 8 * ((i / 2) % 2), q column
      // qh + 8 * (i / 4) + c0 + i % 2
      const bool edge = qh + 31 >= p.Lq || k0 + kKRows - 1 >= p.Lk ||
                        (p.causal && qh < k0 + kKRows - 1) ||
                        (p.has_window && qh + 31 - k0 >= p.window);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int cq = 32 * hq + 8 * (e / 4) + c0 + e % 2;
        const int qpos = q0 + cq;
        const int kpos = r0 + 8 * ((e / 2) % 2);
        const bool keep = !edge || keep_pair(p, qpos, kpos);
        float ds;
        float pr = p_ds(p, st[e], dpt[e], row[cq], row[kKQRows + cq], keep,
                        ds);
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
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with s
  }

  // dk[i], dv[i]: k row r0 + 8 * ((i / 2) % 2), column
  // 128 wg + 8 * (i / 4) + c0 + i % 2
  const long long out0 = static_cast<long long>(bh) * p.Lk * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kpos = r0 + 8 * r;
    if (kpos >= p.Lk) continue;
    float* dkr = p.dk + out0 + static_cast<long long>(kpos) * p.D;
    float* dvr = p.dv + out0 + static_cast<long long>(kpos) * p.D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 128 * wg + 8 * j + c0;
      if (c < p.D) {
        *reinterpret_cast<float2*>(dkr + c) =
            make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
        *reinterpret_cast<float2*>(dvr + c) =
            make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_sm90_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              const __grid_constant__ CUtensorMap domap,
                              const Params p) {
  constexpr int kRowBox = 64 * kRowBytes;       // one 64-row box of Q, dO
  constexpr int kColBox = kQRows * kRowBytes;   // 64 columns of the q tile
  constexpr int kKBox = kQKeys * kRowBytes;     // one box of a K, V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sDO = sQ + kDB * kColBox;
  const uint32_t sK = sDO + kDB * kColBox;
  const uint32_t sV = sK + kStages * kDB * kKBox;
  const uint32_t qd_full = sV + kStages * kDB * kKBox;
  const uint32_t full = qd_full + 8;           // + 8 * stage
  const uint32_t empty = full + 8 * kStages;   // + 8 * stage

  const int bh = blockIdx.x;
  const int n_qt = (p.Lq + kQRows - 1) / kQRows;
  if (flash::grid_tile() >= n_qt) return;  // past the last q tile
  const int iq = n_qt - 1 - flash::grid_tile();
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = iq * kQRows;
  // k tiles wholly above the diagonal hold dS = 0 (masked) for every row
  int n_kt = (p.Lk + kQKeys - 1) / kQKeys;
  if (p.causal) n_kt = min(n_kt, (q0 + kQRows - 1) / kQKeys + 1);

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers / 32);  // one arrival a warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer warpgroup
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(qd_full, 2 * kDB * kColBox);
      for (int rb = 0; rb < kQRows / 64; ++rb)
        for (int cb = 0; cb < kDB; ++cb) {
          const uint32_t off = cb * kColBox + rb * kRowBox;
          tma_load_4d(sQ + off, &qmap, qd_full, 64 * cb, q0 + 64 * rb, h, b);
          tma_load_4d(sDO + off, &domap, qd_full, 64 * cb, q0 + 64 * rb, h,
                      b);
        }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * kDB * kKBox);
        for (int cb = 0; cb < kDB; ++cb) {
          tma_load_4d(sK + (s * kDB + cb) * kKBox, &kmap, full + 8 * s,
                      64 * cb, kt * kQKeys, kvh, b);
          tma_load_4d(sV + (s * kDB + cb) * kKBox, &vmap, full + 8 * s,
                      64 * cb, kt * kQKeys, kvh, b);
        }
      }
    }
    return;
  }

  // -- a consumer warpgroup: q rows [wq, wq + 64) -----------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wq = q0 + 64 * wg;
  // this thread's rows r0 and r0 + 8; its columns 8j + c0 and 8j + c0 + 1
  const int r0 = wq + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  // tiles past this warpgroup's diagonal are all masked for it
  const int n_mine = p.causal ? min(n_kt, (wq + 63) / kQKeys + 1) : n_kt;

  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r0 + 8 * r;
    const long long at = static_cast<long long>(bh) * p.Lq + qpos;
    lse[r] = qpos < p.Lq ? p.lse[at] : 0.f;
    delta[r] = qpos < p.Lq ? p.delta[at] : 0.f;
  }
  // dQ's two 128-column halves, each a m64n128 accumulator
  float dq[2][64];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[c][i] = 0.f;
  const uint64_t q_desc = smem_desc(sQ + wg * kRowBox, 16, 1024);
  const uint64_t do_desc = smem_desc(sDO + wg * kRowBox, 16, 1024);

  mbar_wait(qd_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    if (kt < n_mine) {
      const int k0 = kt * kQKeys;
      const uint32_t sk = sK + s * kDB * kKBox;
      const uint64_t k_kmaj = smem_desc(sk, 16, 1024);
      const uint64_t v_kmaj = smem_desc(sV + s * kDB * kKBox, 16, 1024);
      float sc[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk) {
        // 16 columns of one box: 32 bytes along the swizzled row
        const uint32_t aoff = (kk / 4) * kColBox + (kk % 4) * 32;
        const uint32_t boff = (kk / 4) * kKBox + (kk % 4) * 32;
        wgmma_ss_n32(sc, q_desc + (aoff >> 4), k_kmaj + (boff >> 4), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk) {
        const uint32_t aoff = (kk / 4) * kColBox + (kk % 4) * 32;
        const uint32_t boff = (kk / 4) * kKBox + (kk % 4) * 32;
        wgmma_ss_n32(dp, do_desc + (aoff >> 4), v_kmaj + (boff >> 4),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // sc[i]: row r0 + 8 * ((i / 2) % 2), column k0 + 8 * (i / 4) + c0 + i % 2
      const bool edge = wq + 63 >= p.Lq || k0 + kQKeys > p.Lk ||
                        (p.causal && k0 + kQKeys - 1 > wq) ||
                        (p.has_window && wq + 63 - k0 >= p.window);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
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
      // fragment, split into hi and lo; K read MN-major (the next 64-column
      // box kKBox on), dQ's second half from K's columns 128-255
      uint32_t hi[2][4], lo[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split_pair(dp[8 * t + 2 * a], dp[8 * t + 2 * a + 1], hi[t][a],
                     lo[t][a]);
      const uint64_t k_mnmaj = smem_desc(sk, kKBox, 1024);
      fence_regs(dq[0]);
      fence_regs(dq[1]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint64_t d =
              k_mnmaj + ((t * 16 * kRowBytes + c * 2 * kKBox) >> 4);
          wgmma_rs(dq[c], hi[t], d);
          wgmma_rs(dq[c], lo[t], d);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dq[0]);
      fence_regs(dq[1]);
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
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * c + 8 * j + c0;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(dq[c][4 * j + 2 * r],
                                    dq[c][4 * j + 2 * r + 1]);
      }
  }
}

int run(bool dq, const void* q, const void* k, const void* v,
        const void* dout, const Params& p, long long B, long long q_sb,
        long long q_sh, long long q_sl, long long k_sb, long long k_sh,
        long long k_sl, long long v_sb, long long v_sh, long long v_sl,
        long long do_sb, long long do_sh, long long do_sl, void* stream) {
  if (p.D <= 128 || p.D > kDP) return static_cast<int>(cudaErrorInvalidValue);
  // Q and dO in 64-row boxes (two a dq tile); K and V in 32-row boxes for
  // dq, 64-row ones for dkv
  const unsigned kv_rows = dq ? kQKeys : kKRows;
  CUtensorMap qm, km, vm, dom;
  if (!make_tile_map(&qm, q, B, p.Hq, p.Lq, p.D, q_sb, q_sh, q_sl) ||
      !make_tile_map(&km, k, B, p.Hkv, p.Lk, p.D, k_sb, k_sh, k_sl,
                     kv_rows) ||
      !make_tile_map(&vm, v, B, p.Hkv, p.Lk, p.D, v_sb, v_sh, v_sl,
                     kv_rows) ||
      !make_tile_map(&dom, dout, B, p.Hq, p.Lq, p.D, do_sb, do_sh, do_sl))
    return kEncodeFailed;
  auto kernel = dq ? flash_dq_sm90_d256_kernel : flash_dkv_sm90_d256_kernel;
  const int smem = dq ? kDqSmem : kDkvSmem;
  const long long tiles = dq ? (p.Lq + kQRows - 1) / kQRows
                             : (p.Lk + kKRows - 1) / kKRows;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<flash::tile_grid(B * p.Hq, tiles), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(qm, km, vm, dom, p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(const void* lse, const void* delta, void* dq, void* dk,
                   void* dv, long long Hq, long long Hkv, long long Lq,
                   long long Lk, long long D, int causal, int has_window,
                   long long window, int has_softcap, float softcap,
                   float scale) {
  // |qpos - kpos| < 2^31: a wider window masks nothing more
  const long long max_window = 1LL << 30;
  const long long w = window < max_window ? window : max_window;
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.Hq = static_cast<int>(Hq);
  p.Hkv = static_cast<int>(Hkv);
  p.Lq = static_cast<int>(Lq);
  p.Lk = static_cast<int>(Lk);
  p.D = static_cast<int>(D);
  p.window = static_cast<int>(w > -max_window ? w : -max_window);
  p.scale = scale;
  p.softcap = softcap;
  p.cap2 = has_softcap ? 2.f * kLog2e / softcap : 0.f;
  p.causal = causal;
  p.has_window = has_window;
  p.has_softcap = has_softcap;
  return p;
}

}  // namespace

// q, dout: (B, Hq, Lq, D); k, v: (B, Hkv, Lk, D), bf16, each with the given
// element strides (D contiguous; strides multiples of 8 and the bases
// 16-byte aligned, as TMA needs); lse and delta: (B, Hq, Lq) f32
// contiguous.  dq: (B, Hq, Lq, D) contiguous bf16.  dk, dv: (B, Hq, Lk, D)
// f32 contiguous, one slice per q-head.  head_dim a multiple of 8 above 128
// and up to 256, Hq a multiple of Hkv: the Python wrapper checks all of it.
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

extern "C" int repro_flash_dq_sm90_d256(const void* q, const void* k,
                                        const void* v, const void* dout,
                                        const void* lse, const void* delta,
                                        void* dq, REPRO_FLASH_BWD_SM90_SHAPE) {
  const Params p = make_params(lse, delta, dq, nullptr, nullptr, Hq, Hkv, Lq,
                               Lk, D, causal, has_window, window,
                               has_softcap, softcap, scale);
  return REPRO_FLASH_BWD_SM90_RUN(true);
}

extern "C" int repro_flash_dkv_sm90_d256(const void* q, const void* k,
                                         const void* v, const void* dout,
                                         const void* lse, const void* delta,
                                         void* dk, void* dv,
                                         REPRO_FLASH_BWD_SM90_SHAPE) {
  const Params p = make_params(lse, delta, nullptr, dk, dv, Hq, Hkv, Lq, Lk,
                               D, causal, has_window, window, has_softcap,
                               softcap, scale);
  return REPRO_FLASH_BWD_SM90_RUN(false);
}

extern "C" const char* repro_error_string(int code) {
  if (code == kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a tensor map (or is "
           "unavailable)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
