#!/usr/bin/env python3
"""On-card comparison of the 3xTF32 f32 flash forward with the designs it
was chosen over.

Beside the committed ``csrc/flash_fwd_f32tc.cu``, this script builds
variants from patched copies of the sources under
``build/flash_f32tc_probe/``: other tilings of head_dim 128 (32-key K/V
tiles under 4 or 12 warps a CTA) and
of head_dim 256 (4 warps over 32-key tiles), the exponential as the
accurate ``expf`` instead of ``exp2f`` of x * log2 e, O summed in the
tensor core across every key (``running_accumulator``) instead of each
tile's P.V summed from zero and folded in with one rounding up to head_dim
128, and the
kernel with one TF32 product instead of three (hi*hi alone), which shows
what the split buys.
Each patch must match the committed source exactly once, so a source that
has moved on stops the script instead of timing something else.  It
reports each build's ``ptxas -v`` registers and spills, counts the outputs
each puts beyond the chip check's f32 tolerance
(``chip_smoke.FLASH_TOL``, ``chip_smoke.LSE_TOL``) against the plain
version at the serving shape (``chip_smoke.FLASH_MAIN``, f32) and at
gemma2-2b's (``chip_smoke.FLASH_GEMMA2``) with scores of std 2, and times
all of them in turns (committed, variants, variants reversed, committed),
as ``chip_smoke.time_ms`` does, beside the CUDA-core kernel.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/flash_f32tc_probe.py

It prints one JSON line.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LIB = "flash_fwd_f32tc"
#: variant -> (old, new) replacements in the kernel's source
VARIANTS = {
    "d128_nw4_bk32": [
        ("launch<128, 8, 64>(p, bh, st)",
         "launch<128, 4, 32>(p, bh, st)")],
    "d128_nw12_bk32": [
        ("launch<128, 8, 64>(p, bh, st)",
         "launch<128, 12, 32>(p, bh, st)")],
    "d256_nw4_bk32": [
        ("launch<256, 8, 16>(p, bh, st)",
         "launch<256, 4, 32>(p, bh, st)")],
    "expf": [
        ("exp2f((m[r] - m_new) * kLog2e)", "expf(m[r] - m_new)"),
        ("exp2f((s[j][e] - m[e >> 1]) * kLog2e)",
         "expf(s[j][e] - m[e >> 1])")],
    "running_accumulator": [
        ("constexpr bool kFold = DP <= 128;",
         "constexpr bool kFold = false;")],
    "one_tf32_product": [
        ("#pragma unroll\n"
         "  for (int n = 0; n < G; ++n) mma(c[n], al, bh[n]);\n",
         "  // no lo*hi products\n"),
        ("#pragma unroll\n"
         "  for (int n = 0; n < G; ++n) mma(c[n], ah, bl[n]);\n",
         "  // no hi*lo products\n")],
}


def build_variant(_build, name, patches) -> tuple:
    """The kernel built from a copy of ``csrc/`` with ``patches`` applied,
    bound like the committed library; with its ``ptxas -v`` log."""
    out = ROOT / "build" / "flash_f32tc_probe" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    src = out / "csrc" / f"{LIB}.cu"
    text = src.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in {LIB}.cu once")
        text = text.replace(old, new)
    src.write_text(text)
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


def _gap(got, want, rtol, atol) -> dict:
    """The largest |got - want| and the count beyond atol + rtol*|want|."""
    d = (got.double() - want.double()).abs()
    return {"max_abs_err": float(d.max()),
            "violations": int((d > atol + rtol * want.double().abs()).sum())}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_f32tc_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import flash_attention_ref
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    committed = _build.load(LIB)
    libs = {"committed": committed}
    ptxas = {"committed":
             chip_smoke.ptxas_report(_build.build_all()[LIB]["log"])}
    for name, patches in VARIANTS.items():
        libs[name], log = build_variant(_build, name, patches)
        ptxas[name] = chip_smoke.ptxas_report(log)

    def run(name, q, k, v, masks):
        if name == "simt":
            return FA._launch(q, k, v, 1.0 / math.sqrt(q.shape[-1]), *masks,
                              route="simt")
        _build._libs[LIB] = libs[name]
        return FA._launch(q, k, v, 1.0 / math.sqrt(q.shape[-1]), *masks,
                          route="f32tc")

    rtol, atol = chip_smoke.FLASH_TOL["float32"]
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 9)
    out = {"tolerance": {"o": [rtol, atol], "lse": chip_smoke.LSE_TOL},
           "ptxas": ptxas, "checks": {}, "ms": {}}
    for key, shp in (("serving", chip_smoke.FLASH_MAIN),
                     ("gemma2", chip_smoke.FLASH_GEMMA2)):
        masks = (shp["causal"], shp["window"], shp["softcap"])
        # the check's draw (scores of std 2)
        q, k, v = chip_smoke._qkv(torch, gen, dev, torch.float32,
                                  qk_std=math.sqrt(2.0), **shp)
        want, wlse = flash_attention_ref(q, k, v, None, *masks)
        for name in libs:
            o, lse = run(name, q, k, v, masks)
            torch.cuda.synchronize()
            out["checks"][f"{key}/{name}"] = {
                "o": _gap(o, want, rtol, atol),
                "lse": _gap(lse, wlse, *chip_smoke.LSE_TOL)}
        del want, wlse
        # the timing draw of chip_smoke's phase 8
        q, k, v = chip_smoke._qkv(torch, gen, dev, torch.float32, **shp)
        order = ["committed", *VARIANTS, "simt", *reversed(VARIANTS),
                 "committed"]
        for name in order:
            t = chip_smoke.time_ms(lambda: run(name, q, k, v, masks))
            out["ms"].setdefault(key, {}).setdefault(name, []).append(
                t["median"])
        del q, k, v
    _build._libs[LIB] = committed
    out["device"] = chip_smoke.smi_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
