#!/usr/bin/env python3
"""On-card comparison of the ``pack_rows`` kernel with the designs it was
chosen over.

Beside the committed ``csrc/pack_rows.cu`` (a warp takes 32 rows' table
entries in one load and keeps several rows' vector loads in flight before
it stores), this script builds variants into ``build/pack_rows_probe/``,
each beside a copy of ``csrc/copy_rows.cuh``: two from the sources below,

* ``one_row_a_warp``: the kernel it replaced, one row a warp-iteration
  (the row's two table entries, then its vectors);
* ``bulk_async``: Hopper's bulk asynchronous copies, each thread moving its
  own rows global -> shared -> global with ``cp.async.bulk`` through a
  ring of row buffers, one mbarrier each (rows of at most 1 KB, a multiple
  of 16 bytes, on 16-byte aligned bases: the main path's);

and one from a patched copy of the committed source (each patch must match
it exactly once): ``streaming``, its loads and stores with the
evict-first cache hints (``__ldcs``, ``__stcs``).

Each variant exports the committed library's entry point, so the Python
wrapper drives each of them.  The script reports each build's ``ptxas -v``
summary, checks each bit-exact against the plain version on the main
path's row tables (``chip_smoke.slice_tables``: the merged write of one
8192 x 8192 f32 component, 262,144 rows of 1 KB), and times them in turns
(committed, variants, variants reversed, committed) as
``chip_smoke.time_ms`` does, beside ``copy_`` of the same bytes and the
bound.  Last it times the committed kernel on the same row pairs taken in
the order of their destination rows (``dst_ordered_ms``: the same bytes
moved, the writes streaming as ``copy_``'s do), which tells how much of
the gap to ``copy_`` the main path's scattered writes cost.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/pack_rows_probe.py

It prints one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
LIB = "pack_rows"

ONE_ROW_A_WARP = r"""
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
"""

BULK_ASYNC = r"""
#include <stdint.h>

#include "copy_rows.cuh"

namespace {

constexpr int kThreadsB = 32;     // a block: one warp of copy engines
constexpr int kSlots = 6;         // row buffers a thread
constexpr int kSlotBytes = 1024;  // the longest row taken

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__global__ void __launch_bounds__(kThreadsB)
    pack_rows_bulk(const char* __restrict__ src, char* __restrict__ dst,
                   const int* __restrict__ src_rows,
                   const int* __restrict__ dst_rows, long long n_rows,
                   unsigned row_bytes) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long bars[kThreadsB * kSlots];
  unsigned char* mine = ring + threadIdx.x * kSlots * kSlotBytes;
  uint32_t bar[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    bar[s] = smem_u32(&bars[threadIdx.x * kSlots + s]);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(bar[s]) : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreadsB + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreadsB;

  auto load = [&](long long i, int s) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar[s]), "r"(row_bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(mine + s * kSlotBytes)),
           "l"(src + static_cast<long long>(src_rows[i]) * row_bytes),
           "r"(row_bytes), "r"(bar[s])
        : "memory");
  };

#pragma unroll
  for (int s = 0; s < kSlots; ++s)
    if (first + s * step < n_rows) load(first + s * step, s);
  for (long long j = 0;; ++j) {
    const long long i = first + j * step;
    if (i >= n_rows) break;
    const int s = static_cast<int>(j % kSlots);
    const uint32_t parity = static_cast<uint32_t>((j / kSlots) & 1);
    uint32_t done;
    do {
      asm volatile(
          "{\n.reg .pred p;\n"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(bar[s]), "r"(parity) : "memory");
    } while (!done);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(dst + static_cast<long long>(dst_rows[i]) * row_bytes),
                    "r"(smem_u32(mine + s * kSlotBytes)), "r"(row_bytes)
                 : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    const long long next = i + kSlots * step;
    if (next < n_rows) {
      // the slot refills once this row's store has read it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      load(next, s);
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

extern "C" int repro_pack_rows(const void* src, void* dst, const int* src_rows,
                               const int* dst_rows, long long n_rows,
                               long long row_bytes, void* stream) {
  if (repro::vector_bytes(src, dst, row_bytes) != 16 ||
      row_bytes > kSlotBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kThreadsB * kSlots * kSlotBytes;
  cudaError_t err = cudaFuncSetAttribute(
      pack_rows_bulk, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, pack_rows_bulk, kThreadsB, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n_rows + kThreadsB - 1) / kThreadsB;
  if (blocks > static_cast<long long>(sms) * per_sm)
    blocks = static_cast<long long>(sms) * per_sm;
  pack_rows_bulk<<<static_cast<unsigned>(blocks), kThreadsB, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst), src_rows,
      dst_rows, n_rows, static_cast<unsigned>(row_bytes));
  return static_cast<int>(cudaGetLastError());
}
"""

#: variant -> its whole source, or (old, new) replacements in the
#: committed source
VARIANTS = {
    "one_row_a_warp": ONE_ROW_A_WARP,
    "bulk_async": BULK_ASYNC,
    "streaming": [
        ("tmp[u][v] = s[u][k + 32 * v];",
         "tmp[u][v] = __ldcs(&s[u][k + 32 * v]);"),
        ("d[u][k + 32 * v] = tmp[u][v];",
         "__stcs(&d[u][k + 32 * v], tmp[u][v]);")],
}


def build_variant(_build, name, source) -> tuple:
    """The variant built beside a copy of ``csrc/copy_rows.cuh`` and bound
    like the committed library; with its ``ptxas -v`` log."""
    out = ROOT / "build" / "pack_rows_probe" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    shutil.copy(_build.CSRC / "copy_rows.cuh", out / "copy_rows.cuh")
    if not isinstance(source, str):
        text = (_build.CSRC / f"{LIB}.cu").read_text()
        for old, new in source:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {LIB}.cu "
                                   f"once")
            text = text.replace(old, new)
        source = text
    src = out / f"{LIB}.cu"
    src.write_text(source)
    lib = out / f"lib{LIB}.so"
    done = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)],
                          check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    for entry, argtypes in _build.SOURCES[LIB].items():
        fn = getattr(cdll, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    cdll.repro_error_string.argtypes = [ctypes.c_int]
    cdll.repro_error_string.restype = ctypes.c_char_p
    return cdll, done.stdout + done.stderr


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("pack_rows_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.core import (plan_layout, simulate_load_balance,
                                  uniform_grid_blocks)
    from repro_torch.kernels import _build, pack_blocks
    from repro_torch.kernels.ref import pack_rows_ref
    dev = torch.device("cuda", 0)
    committed = _build.load(LIB)
    libs = {"committed": committed}
    ptxas = {"committed":
             chip_smoke.ptxas_report(_build.build_all()[LIB]["log"])}
    for name, source in VARIANTS.items():
        libs[name], log = build_variant(_build, name, source)
        ptxas[name] = chip_smoke.ptxas_report(log)

    blocks = simulate_load_balance(
        uniform_grid_blocks(chip_smoke.FIELD, chip_smoke.BLOCK),
        num_procs=chip_smoke.NPROCS, seed=chip_smoke.SEED)
    layout = plan_layout("merged_process", blocks,
                         num_procs=chip_smoke.NPROCS,
                         procs_per_node=chip_smoke.PPN)
    width, sr, dr, total, _ = chip_smoke.slice_tables(layout)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 2)
    src = torch.randn(total, generator=gen, device=dev)
    sr_t, dr_t = (torch.from_numpy(a).to(dev) for a in (sr, dr))
    n_dst = total // width
    want = pack_rows_ref(src, sr_t, dr_t, n_dst_rows=n_dst, width=width)
    out = torch.empty((n_dst, width), device=dev)

    def run(name):
        _build._libs[LIB] = libs[name]
        pack_blocks.launch(src, out, sr_t, dr_t, width)

    res = {"shape": {"rows": len(sr), "width": width, "dtype": "float32"},
           "bytes": 2 * len(sr) * width * 4 + 2 * len(sr) * 4,
           "ptxas": ptxas, "bit_exact": {}, "ms": {}}
    res["bound_ms"] = res["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3
    for name in libs:
        out.fill_(float("nan"))
        run(name)
        torch.cuda.synchronize()
        res["bit_exact"][name] = bool(torch.equal(out, want))
    order = ["committed", *VARIANTS, *reversed(VARIANTS), "committed"]
    for name in order:
        res["ms"].setdefault(name, []).append(
            chip_smoke.time_ms(lambda: run(name))["median"])
    _build._libs[LIB] = committed
    copy_dst = torch.empty_like(src)
    res["copy_ms"] = chip_smoke.time_ms(lambda: copy_dst.copy_(src))["median"]
    order = np.argsort(dr, kind="stable")
    sr_o, dr_o = (torch.from_numpy(np.ascontiguousarray(a[order])).to(dev)
                  for a in (sr, dr))
    out.fill_(float("nan"))
    pack_blocks.launch(src, out, sr_o, dr_o, width)
    torch.cuda.synchronize()
    res["bit_exact"]["dst_ordered"] = bool(torch.equal(out, want))
    res["dst_ordered_ms"] = chip_smoke.time_ms(
        lambda: pack_blocks.launch(src, out, sr_o, dr_o, width))["median"]
    res["device"] = chip_smoke.smi_line()
    print(json.dumps(res), flush=True)
    if not all(res["bit_exact"].values()):
        print("pack_rows_probe: a design is not bit-exact", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
