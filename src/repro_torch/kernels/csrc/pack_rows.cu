// pack_rows: dst[dst_rows[i]] = src[src_rows[i]], rows of row_bytes bytes.
//
// Replaces the Pallas kernel `_pack_kernel` of
// src/repro/kernels/pack_blocks.py (launched by `pack_rows`), the merge copy
// of the paper's Alg. 1 and the read-side linearization of stored chunks.
//
// Bound on this card: memory.  It reads R*row_bytes and writes the same
// (plus the zero fill of the output, which the wrapper does with
// torch.zeros), with no arithmetic to speak of, so the floor is
// bytes / 3.35 TB/s.  On the TPU the row tables were scalar-prefetched into
// SMEM and each grid step DMA'd one row through VMEM.  Here there is no
// scalar prefetch: each warp loads its own pair of row indices (one
// broadcast load each) and moves the row with 16-byte vector accesses on
// neighbouring lanes whenever the row length and both bases allow it, so
// every load and store is a full coalesced transaction.  A grid-stride loop
// keeps the grid at a fixed size while many rows stay in flight.
#include "copy_rows.cuh"

namespace {

template <typename V>
__global__ void __launch_bounds__(repro::kThreads)
    pack_rows_kernel(const char* __restrict__ src, char* __restrict__ dst,
                     const int* __restrict__ src_rows,
                     const int* __restrict__ dst_rows, long long n_rows,
                     long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  for (long long i = warp; i < n_rows; i += n_warps) {
    const long long s = src_rows[i];
    const long long d = dst_rows[i];
    repro::copy_row<V>(src + s * row_bytes, dst + d * row_bytes, row_bytes,
                       lane);
  }
}

template <typename V>
void launch(const void* src, void* dst, const int* src_rows,
            const int* dst_rows, long long n_rows, long long row_bytes,
            cudaStream_t stream) {
  pack_rows_kernel<V><<<repro::grid_for(n_rows), repro::kThreads, 0,
                        stream>>>(static_cast<const char*>(src),
                                  static_cast<char*>(dst), src_rows, dst_rows,
                                  n_rows, row_bytes);
}

}  // namespace

// Row indices must lie inside src and dst: the Python wrapper checks them.
extern "C" int repro_pack_rows(const void* src, void* dst, const int* src_rows,
                               const int* dst_rows, long long n_rows,
                               long long row_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (repro::vector_bytes(src, dst, row_bytes)) {
    case 16: launch<uint4>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
    case 8: launch<uint2>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
    case 4: launch<unsigned int>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
    case 2: launch<unsigned short>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
    default: launch<unsigned char>(src, dst, src_rows, dst_rows, n_rows, row_bytes, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
