// The grid of every flash-attention kernel: one block per (batch*head,
// tile), batch*head on x (up to 2^31 - 1) and the tiles on y, folded into
// z past y's limit of 65,535, so neither B*Hq nor the sequence length is
// held to a grid extent.  Blocks of the last z slice past the tile count
// exit at once.  Launch order is x fastest: every head's tile 0 first.
#pragma once

#include <cuda_runtime.h>

namespace flash {

// The grid for `bh` batch*heads and `tiles` tiles (at least one).
inline dim3 tile_grid(long long bh, long long tiles) {
  const long long t = tiles < 1 ? 1 : tiles;
  const long long y = t < 65535 ? t : 65535;
  return dim3(static_cast<unsigned>(bh), static_cast<unsigned>(y),
              static_cast<unsigned>((t + y - 1) / y));
}

// This block's tile, counted over y and then z (fewer than 2^31 tiles; in
// 32 bits, which holds the kernels' register use below 64-bit arithmetic).
__device__ __forceinline__ int grid_tile() {
  return static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
}

}  // namespace flash
