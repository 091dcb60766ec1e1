// flash_fwd_sm90_d256: the online-softmax attention forward for bf16 inputs
// with head_dim above 128 and up to 256, on Hopper's tensor cores (wgmma)
// fed by TMA.
//
// Replaces the Pallas kernel `_fwd_kernel` of
// src/repro/kernels/flash_attention.py:39 (launched by `_fwd` at :80), the
// prefill attention of every layer on the flash route, for bf16 q, k, v
// with 128 < head_dim <= 256, padded to 256 (gemma2-2b's 256 runs
// unpadded); flash_fwd_sm90.cu takes the narrower bf16 heads and
// flash_fwd.cu f32 inputs.  Same function as both: scale, then softcap
// c*tanh(s/c); mask qpos >= kpos when causal and (qpos - kpos) < window
// whenever a window is set (one-sided, even when non-causal); masked scores
// are the finite -1e30 of the reference, columns past Lk are -inf; O in
// bf16, rounded once from f32; LSE = m + log(max(l, 1e-30)) in f32; GQA
// q-head h of batch b reads kv-head h / (Hq / Hkv).  Exponentials are
// exp2f((s - m) * log2(e)), logf for the LSE (no fast math).  The softcap is
// c - 2c / (exp(2x/c) + 1), from exp2f and a fast division: with tanhf the
// kernel took about a third longer at gemma2-2b's shape
// (tools/flash_d256_probe.py times both; PERF.md), and this form's absolute
// error, a few 1e-7 of c, moves a score by about 1e-5 (tanh.approx.f32's
// 2^-11 of c would move it by 0.02).
//
// Bound on this card: operations.  A live (q, k) pair costs 4*D flops of
// useful work against Q, K, V and O read or written once, far above the
// ~300 flops/byte where device memory stops being the limit: the bf16
// tensor cores' 989 TFLOP/s set the bound.  The split of P below makes
// this kernel's own work 6*D flops a pair.
//
// Design.  flash_fwd_sm90.cu's kernel does not fit at D 256: a 64-row
// warpgroup's O accumulator alone is 128 f32 registers a thread, beside S
// (32) and P's two bf16 halves (32), where 288 threads cap a thread at 168
// registers; and its 3-stage ring of 64-row K and V tiles would need
// 64 KB (Q) + 3 x 64 KB of shared memory, beyond the 227 KB a block may
// use.  So here one CTA of 384 threads per (batch*head, 128-row q tile):
// two consumer warpgroups of 64 q rows each, and a producer warpgroup that
// lowers itself to kProducerRegs registers a thread (setmaxnreg) so that
// the consumers can rise to kConsumerRegs.  The producer's first lane loads
// the Q tile once and then kBK-row K and V tiles through a ring of kStages
// stages with TMA (4-D tensor maps over the strided (B, H, L, D) views, so
// the model's transposed projections are read in place; 128-byte swizzle,
// 64-column boxes; TMA's zero fill pads ragged Lq, Lk and head dims such
// as 136 or 200 up to 256), each stage guarded by a full and an empty
// mbarrier: Q 64 KB + 2 x (K 32 KB + V 32 KB), 193 KB with the barriers
// and alignment.  Tiles wholly above the causal diagonal are never loaded.
// Each consumer warpgroup, per k tile:
//   S = Q.K^T      wgmma m64n64k16 over 16 k-steps (4 boxes of 64
//                  columns), both operands K-major in shared memory, bf16
//                  products summed in f32 (exact products);
//   softmax        scale, softcap, masks on the accumulator fragment (a
//                  thread holds two rows, four lanes share a row: max by two
//                  shuffles), running max m, f32 row sums l from f32 P;
//   O += P.V       P split into hi = bf16(P) and lo = bf16(P - hi), each
//                  re-packed from S's accumulator layout into wgmma's
//                  register A fragments; per 16 keys four wgmma m64n128k16,
//                  hi and lo into each 128-column half of O, V read
//                  MN-major from shared memory (the second half two boxes
//                  in).
// P is split because the check holds bf16 O to one bf16 step of the f32
// reference; one bf16 P (error up to 2^-9 of P) moves O by more than that
// on a share of the outputs (tests/test_torch_flash_split.py emulates both
// at D 256).  O is divided by l and stored from registers; rows past Lq and
// columns past D are not stored.  The grid is flash_grid.cuh's
// (batch*head, q tile), the heaviest causal q tiles first.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_grid.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kDP = 256;                   // padded head dim
constexpr int kDB = kDP / 64;              // 64-column boxes per row
constexpr int kBM = 128;                   // q rows per CTA
constexpr int kBK = 64;                   // k rows per tile
constexpr int kStages = 2;                 // K/V ring depth
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // a thread
constexpr int kRowBytes = 128;             // 64 bf16 columns, one box
constexpr int kQBoxBytes = 64 * kRowBytes;  // one 64-row box of Q
constexpr int kKVBoxBytes = kBK * kRowBytes;  // one kBK-row box of K or V
constexpr int kNS = kBK / 2;               // S accumulator floats a thread
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kEncodeFailed = 0x10000;  // returned when TMA maps fail

struct Params {
  __nv_bfloat16* o;
  float* lse;
  int Hq, Hkv, Lq, Lk, D, window;
  float scale, softcap;
  int causal, has_window, has_softcap;
};

// Shared memory: Q (kDB boxes of 128 rows), the K ring, the V ring (kDB
// boxes of kBK rows a stage), then the barriers; plus 1024 bytes of
// alignment.
constexpr int kSmemBytes = kDB * kBM * kRowBytes +
                           2 * kStages * kDB * kKVBoxBytes +
                           8 * (1 + 2 * kStages) + 1024;

// The softcap c*tanh(x/c) as c - 2c / (exp(2x/c) + 1).
__device__ __forceinline__ float cap_score(float x, float c) {
  const float e = exp2f(fminf(x * ((2.f * kLog2e) / c), 64.f));
  return c - __fdividef(2.f * c, e + 1.f);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_d256_kernel(const __grid_constant__ CUtensorMap qmap,
                               const __grid_constant__ CUtensorMap kmap,
                               const __grid_constant__ CUtensorMap vmap,
                               const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + kDB * kBM * kRowBytes;
  const uint32_t sV = sK + kStages * kDB * kKVBoxBytes;
  const uint32_t q_full = sV + kStages * kDB * kKVBoxBytes;
  const uint32_t full = q_full + 8;              // + 8 * stage
  const uint32_t empty = full + 8 * kStages;     // + 8 * stage

  const int bh = blockIdx.x;
  const int n_qt = (p.Lq + kBM - 1) / kBM;
  if (flash::grid_tile() >= n_qt) return;  // past the last q tile
  const int iq = n_qt - 1 - flash::grid_tile();
  const int b = bh / p.Hq, h = bh % p.Hq;
  const int kvh = h / (p.Hq / p.Hkv);
  const int q0 = iq * kBM;
  int n_kt = (p.Lk + kBK - 1) / kBK;
  if (p.causal) n_kt = min(n_kt, (q0 + kBM - 1) / kBK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_expect_tx(q_full, kDB * kBM * kRowBytes);
      for (int rb = 0; rb < kBM / 64; ++rb)
        for (int cb = 0; cb < kDB; ++cb)
          tma_load_4d(sQ + cb * kBM * kRowBytes + rb * kQBoxBytes, &qmap,
                      q_full, 64 * cb, q0 + 64 * rb, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        mbar_wait(empty + 8 * s, ((kt / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * kDB * kKVBoxBytes);
        for (int cb = 0; cb < kDB; ++cb) {
          tma_load_4d(sK + (s * kDB + cb) * kKVBoxBytes, &kmap, full + 8 * s,
                      64 * cb, kt * kBK, kvh, b);
          tma_load_4d(sV + (s * kDB + cb) * kKVBoxBytes, &vmap, full + 8 * s,
                      64 * cb, kt * kBK, kvh, b);
        }
      }
    }
    return;
  }

  // -- a consumer warpgroup: q rows [wq, wq + 64) ----------------------------
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wq = q0 + 64 * wg;
  // this thread's rows r0 and r0 + 8; its columns 8j + c0 and 8j + c0 + 1
  const int r0 = wq + 16 * warp + lane / 4;
  const int c0 = 2 * (lane % 4);
  // tiles past this warpgroup's diagonal are all masked for it
  const int n_mine = p.causal ? min(n_kt, (wq + 63) / kBK + 1) : n_kt;

  // O's two 128-column halves, each a m64n128 accumulator
  float o[2][64];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 64; ++i) o[c][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const uint64_t q_desc = smem_desc(sQ + wg * kQBoxBytes, 16, 1024);

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % kStages;
    mbar_wait(full + 8 * s, (kt / kStages) & 1);
    if (kt < n_mine) {
      const int k0 = kt * kBK;
      const uint64_t k_desc = smem_desc(sK + s * kDB * kKVBoxBytes, 16, 1024);
      float sc[kNS];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kDP / 16; ++kk) {
        // 16 columns of one box: 32 bytes along the swizzled row
        const uint32_t qoff = (kk / 4) * kBM * kRowBytes + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * kKVBoxBytes + (kk % 4) * 32;
        wgmma_ss_n64(sc, q_desc + (qoff >> 4), k_desc + (koff >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // sc[i]: row r0 + 8 * ((i / 2) % 2), column k0 + 8 * (i / 4) + c0 + i % 2
      const bool masked = k0 + kBK > p.Lk ||
                          (p.causal && k0 + kBK - 1 > wq) ||
                          (p.has_window && wq + 63 - k0 >= p.window);
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        float x = sc[i] * p.scale;
        if (p.has_softcap) x = cap_score(x, p.softcap);
        if (masked) {
          const int qpos = r0 + 8 * ((i / 2) % 2);
          const int kpos = k0 + 8 * (i / 4) + c0 + i % 2;
          bool keep = true;
          if (p.causal) keep = keep && qpos >= kpos;
          if (p.has_window) keep = keep && (qpos - kpos) < p.window;
          x = keep ? x : kNeg;
          if (kpos >= p.Lk) x = -INFINITY;
        }
        sc[i] = x;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        l[r] *= alpha[r];  // this thread's share of the row; summed at the end
      }
#pragma unroll
      for (int i = 0; i < kNS; ++i) {
        const int r = (i / 2) % 2;
        sc[i] = exp2f((sc[i] - m[r]) * kLog2e);
        l[r] += sc[i];
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < 64; ++i) o[c][i] *= alpha[(i / 2) % 2];

      // 16 keys per k step: accumulator blocks 2t and 2t + 1 are wgmma's
      // A fragment (rows r0, r0 + 8; columns c0, c0 + 1, c0 + 8, c0 + 9)
      uint32_t hi[kBK / 16][4], lo[kBK / 16][4];
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split_pair(sc[8 * t + 2 * a], sc[8 * t + 2 * a + 1], hi[t][a],
                     lo[t][a]);
      // V MN-major: the next 64-column box is kKVBoxBytes on; O's second
      // half reads columns 128-255, two boxes in
      const uint64_t v_desc =
          smem_desc(sV + s * kDB * kKVBoxBytes, kKVBoxBytes, 1024);
      fence_regs(o[0]);
      fence_regs(o[1]);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const uint64_t d =
              v_desc + ((t * 16 * kRowBytes + c * 2 * kKVBoxBytes) >> 4);
          wgmma_rs(o[c], hi[t], d);
          wgmma_rs(o[c], lo[t], d);
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o[0]);
      fence_regs(o[1]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);  // this warp is done with s
  }

  __nv_bfloat16* ob = p.o + static_cast<long long>(bh) * p.Lq * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = r0 + 8 * r;
    if (qpos >= p.Lq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<long long>(qpos) * p.D;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = 128 * c + 8 * j + c0;
        if (col < p.D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * j + 2 * r] / lc,
                                    o[c][4 * j + 2 * r + 1] / lc);
      }
    if (lane % 4 == 0)
      p.lse[static_cast<long long>(bh) * p.Lq + qpos] = m[r] + logf(lc);
  }
}

}  // namespace

// q: (B, Hq, Lq, D), k/v: (B, Hkv, Lk, D) bf16 with the given element
// strides (D contiguous; strides multiples of 8 and the bases 16-byte
// aligned, as TMA needs); o: (B, Hq, Lq, D) contiguous bf16; lse: (B, Hq,
// Lq) f32.  head_dim a multiple of 8 above 128 and up to 256, Hq a
// multiple of Hkv: the Python wrapper checks all of it.
extern "C" int repro_flash_fwd_sm90_d256(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long B, long long Hq, long long Hkv, long long Lq, long long Lk,
    long long D, long long q_sb, long long q_sh, long long q_sl,
    long long k_sb, long long k_sh, long long k_sl, long long v_sb,
    long long v_sh, long long v_sl, int causal, int has_window,
    long long window, int has_softcap, float softcap, float scale,
    void* stream) {
  if (D <= 128 || D > kDP) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if (!make_tile_map(&qm, q, B, Hq, Lq, D, q_sb, q_sh, q_sl) ||
      !make_tile_map(&km, k, B, Hkv, Lk, D, k_sb, k_sh, k_sl, kBK) ||
      !make_tile_map(&vm, v, B, Hkv, Lk, D, v_sb, v_sh, v_sl, kBK))
    return kEncodeFailed;
  // |qpos - kpos| < 2^31: a wider window masks nothing more
  const long long max_window = 1LL << 30;
  const long long w = window < max_window ? window : max_window;
  Params p{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
           static_cast<int>(Hq), static_cast<int>(Hkv), static_cast<int>(Lq),
           static_cast<int>(Lk), static_cast<int>(D),
           static_cast<int>(w > -max_window ? w : -max_window), scale,
           softcap, causal, has_window, has_softcap};
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_d256_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_sm90_d256_kernel<<<flash::tile_grid(B * Hq, (Lq + kBM - 1) / kBM),
                               kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(qm, km,
                                                                     vm, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_error_string(int code) {
  if (code == kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a tensor map (or is "
           "unavailable)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
