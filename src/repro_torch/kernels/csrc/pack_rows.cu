// pack_rows: dst[dst_rows[i]] = src[src_rows[i]], rows of row_bytes bytes.
//
// Replaces the Pallas kernel `_pack_kernel` of
// src/repro/kernels/pack_blocks.py (launched by `pack_rows`), the merge copy
// of the paper's Alg. 1 and the read-side linearization of stored chunks.
//
// Bound on this card: memory.  It reads R*row_bytes and the two R-entry
// int32 tables and writes R*row_bytes, with no arithmetic to speak of, so
// the floor is bytes / 3.35 TB/s.  The output's fill, where rows are not
// all named, is the wrapper's (torch.zeros), outside this kernel.  On the
// TPU the row tables were scalar-prefetched into SMEM and each grid step
// DMA'd one row through VMEM.  Here a row costs two dependent trips to
// device memory (its table entries, then its bytes).  Each warp takes 32
// rows at a time: one coalesced load of 32 entries of each table (the next
// 32 already on their way while these rows move), handed to the lanes by
// shuffle; then kRows rows at once, every lane issuing its kRows x kVecs
// vector loads before the first store, so a warp has kRows row lengths
// (4 KB of 1 KB rows) in flight.  Vectors are 16 bytes on neighbouring
// lanes whenever the row length and both bases allow it (else 8, 4, 2 or
// 1: copy_rows.cuh's vector_bytes), so every access is a full coalesced
// transaction.  The grid is what the card holds resident at
// once (the SM count times the blocks an SM takes), and the warps walk
// their 32-row runs with a grid stride.  Neither bytes in flight nor the
// order of the writes is what holds it at about 1.2x its floor and 1.08x
// copy_ of the same bytes: tools/pack_rows_probe.py times this beside the
// one-row-a-warp parent, a design on Hopper's bulk asynchronous copies
// (rows through shared memory, an mbarrier ring) and this one with
// evict-first cache hints, all within 0.19-0.23 ms on the main path's
// tables, and this one on the same rows in destination order (the writes
// streaming), which takes the time of the scattered order.
#include "copy_rows.cuh"

namespace {

constexpr int kRows = 4;  // rows a warp loads before it stores
constexpr int kVecs = 2;  // vectors of a row a lane loads in one pass

template <typename V>
__global__ void __launch_bounds__(repro::kThreads)
    pack_rows_kernel(const char* __restrict__ src, char* __restrict__ dst,
                     const int* __restrict__ src_rows,
                     const int* __restrict__ dst_rows, long long n_rows,
                     long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long stride =
      32 * ((static_cast<long long>(gridDim.x) * blockDim.x) >> 5);
  const long long n = row_bytes / static_cast<long long>(sizeof(V));
  long long base = 32 * warp;
  int s_next = 0, d_next = 0;
  if (base + lane < n_rows) {
    s_next = src_rows[base + lane];
    d_next = dst_rows[base + lane];
  }
  for (; base < n_rows; base += stride) {
    const int s_mine = s_next, d_mine = d_next;
    if (base + stride + lane < n_rows) {  // the next run's entries
      s_next = src_rows[base + stride + lane];
      d_next = dst_rows[base + stride + lane];
    }
    const int cnt = static_cast<int>(n_rows - base < 32 ? n_rows - base : 32);
    for (int r = 0; r < cnt; r += kRows) {
      const V* s[kRows];
      V* d[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const long long sr = __shfl_sync(0xffffffffu, s_mine, r + u);
        const long long dr = __shfl_sync(0xffffffffu, d_mine, r + u);
        s[u] = reinterpret_cast<const V*>(src + sr * row_bytes);
        d[u] = reinterpret_cast<V*>(dst + dr * row_bytes);
      }
      for (long long k = lane; k < n; k += 32 * kVecs) {
        V tmp[kRows][kVecs];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int v = 0; v < kVecs; ++v)
            if (r + u < cnt && k + 32 * v < n) tmp[u][v] = s[u][k + 32 * v];
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int v = 0; v < kVecs; ++v)
            if (r + u < cnt && k + 32 * v < n) d[u][k + 32 * v] = tmp[u][v];
      }
    }
  }
}

template <typename V>
cudaError_t launch(const void* src, void* dst, const int* src_rows,
                   const int* dst_rows, long long n_rows, long long row_bytes,
                   cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pack_rows_kernel<V>, repro::kThreads, 0);
  if (err != cudaSuccess) return err;
  // one 32-row run a warp at most, no more blocks than are resident
  const long long runs = (n_rows + 31) / 32;
  long long blocks = (runs + repro::kWarpsPerBlock - 1) / repro::kWarpsPerBlock;
  const long long resident = static_cast<long long>(sms) * per_sm;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  pack_rows_kernel<V><<<static_cast<unsigned>(blocks), repro::kThreads, 0,
                        stream>>>(static_cast<const char*>(src),
                                  static_cast<char*>(dst), src_rows, dst_rows,
                                  n_rows, row_bytes);
  return cudaGetLastError();
}

}  // namespace

// Row indices must lie inside src and dst: the Python wrapper checks them.
extern "C" int repro_pack_rows(const void* src, void* dst, const int* src_rows,
                               const int* dst_rows, long long n_rows,
                               long long row_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (repro::vector_bytes(src, dst, row_bytes)) {
    case 16: err = launch<uint4>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
    case 8: err = launch<uint2>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
    case 4: err = launch<unsigned int>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
    case 2: err = launch<unsigned short>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
    default: err = launch<unsigned char>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
  }
  return static_cast<int>(err);
}
