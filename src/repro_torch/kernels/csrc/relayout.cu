// relayout: the chunk-grid relayout between a row-major (H, W) array and
// its (H/ch, W/cw, ch, cw) stored-chunk tensor, in either direction.
//
// Replaces the Pallas kernels `_unchunk_kernel` (chunked_to_rowmajor) and
// `_chunk_kernel` (rowmajor_to_chunked) of src/repro/kernels/relayout.py.
//
// Bound on this card: memory.  Each direction reads the array once and
// writes it once (2 * H * W * itemsize bytes) and computes only addresses,
// so the floor is bytes / 3.35 TB/s.  The TPU version moved one (ch, cw)
// tile through VMEM per grid step, with the affine maps in BlockSpecs.
// Here both directions are the same set of row copies of cw contiguous
// elements: warp q writes destination row q (so stores stream through the
// destination in order) and reads the source row the affine map names, one
// template with the two index maps swapped.  Rows move with 16-byte vector
// accesses on neighbouring lanes whenever cw * itemsize and both bases
// allow it.
#include "copy_rows.cuh"

namespace {

template <typename V, bool kToRowmajor>
__global__ void __launch_bounds__(repro::kThreads)
    relayout_kernel(const char* __restrict__ src, char* __restrict__ dst,
                    long long n_i, long long n_j, long long ch,
                    long long row_bytes) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long n_warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const long long n_rows = n_i * ch * n_j;
  for (long long q = warp; q < n_rows; q += n_warps) {
    long long s;
    if (kToRowmajor) {
      // q = (i * ch + r) * n_j + j in the row-major array;
      // source row (i * n_j + j) * ch + r of the chunk tensor
      const long long row = q / n_j, j = q - row * n_j;
      const long long i = row / ch, r = row - i * ch;
      s = (i * n_j + j) * ch + r;
    } else {
      // q = (i * n_j + j) * ch + r in the chunk tensor;
      // source row (i * ch + r) * n_j + j of the row-major array
      const long long t = q / ch, r = q - t * ch;
      const long long i = t / n_j, j = t - i * n_j;
      s = (i * ch + r) * n_j + j;
    }
    repro::copy_row<V>(src + s * row_bytes, dst + q * row_bytes, row_bytes,
                       lane);
  }
}

template <typename V>
void launch(const void* src, void* dst, long long n_i, long long n_j,
            long long ch, long long row_bytes, int to_rowmajor,
            cudaStream_t stream) {
  const dim3 grid = repro::grid_for(n_i * ch * n_j);
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);
  if (to_rowmajor)
    relayout_kernel<V, true><<<grid, repro::kThreads, 0, stream>>>(
        s, d, n_i, n_j, ch, row_bytes);
  else
    relayout_kernel<V, false><<<grid, repro::kThreads, 0, stream>>>(
        s, d, n_i, n_j, ch, row_bytes);
}

}  // namespace

// row_bytes = cw * itemsize; src and dst each hold n_i * n_j * ch rows.
extern "C" int repro_relayout(const void* src, void* dst, long long n_i,
                              long long n_j, long long ch, long long row_bytes,
                              int to_rowmajor, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (repro::vector_bytes(src, dst, row_bytes)) {
    case 16: launch<uint4>(src, dst, n_i, n_j, ch, row_bytes, to_rowmajor, st); break;
    case 8: launch<uint2>(src, dst, n_i, n_j, ch, row_bytes, to_rowmajor, st); break;
    case 4: launch<unsigned int>(src, dst, n_i, n_j, ch, row_bytes, to_rowmajor, st); break;
    case 2: launch<unsigned short>(src, dst, n_i, n_j, ch, row_bytes, to_rowmajor, st); break;
    default: launch<unsigned char>(src, dst, n_i, n_j, ch, row_bytes, to_rowmajor, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
