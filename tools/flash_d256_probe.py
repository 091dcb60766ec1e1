#!/usr/bin/env python3
"""On-card comparison of the head_dim-256 flash forward with the designs
it was chosen over.

Beside the committed ``csrc/flash_fwd_sm90_d256.cu`` (64-row K/V tiles in a
2-stage ring; the softcap c*tanh(x/c) as c - 2c / (exp(2x/c) + 1)), this
script builds two variants from patched copies of the sources: 32-row K/V
tiles in a 3-stage ring, and the softcap through ``tanhf``.  Each patch
must match the committed source exactly once, so a source that has moved
on stops the script instead of timing something else.  It reports each
build's ``ptxas -v`` registers and spills, checks it against the plain
version at
gemma2-2b's shape (``chip_smoke.FLASH_GEMMA2``: B 4, Hq 8, Hkv 4, L 2048,
D 256, causal, window 4096, softcap 50, bf16) and under a window of 96,
within the chip check's tolerances (``chip_smoke.FLASH_TOL``,
``chip_smoke.LSE_TOL``), and times all of them with and without the
softcap, in turns (committed, variants, variants reversed, committed), as
``chip_smoke.time_ms`` does.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/flash_d256_probe.py

It prints one JSON line; the patched copies are built under
``build/flash_d256_probe/``.
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
LIB = "flash_fwd_sm90_d256"
#: variant -> (old, new) replacements in the kernel's source
VARIANTS = {
    "bk32_3_stages": [
        ("constexpr int kBK = 64;", "constexpr int kBK = 32;"),
        ("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
        ("wgmma_ss_n64(sc, q_desc", "wgmma_ss_n32(sc, q_desc")],
    "tanhf_softcap": [
        ("  const float e = exp2f(fminf(x * ((2.f * kLog2e) / c), 64.f));\n"
         "  return c - __fdividef(2.f * c, e + 1.f);",
         "  return c * tanhf(x / c);")],
}


def build_variant(_build, name, patches) -> tuple:
    """The kernel built from a copy of ``csrc/`` with ``patches`` applied,
    bound like the committed library; with its ``ptxas -v`` log."""
    out = ROOT / "build" / "flash_d256_probe" / name
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
        print("flash_d256_probe: no CUDA device", file=sys.stderr)
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

    def run(name, q, k, v, window, softcap):
        _build._libs[LIB] = libs[name]
        return FA._launch(q, k, v, 1.0 / math.sqrt(q.shape[-1]), True,
                          window, softcap, route="sm90")

    shp = chip_smoke.FLASH_GEMMA2
    rtol, atol = chip_smoke.FLASH_TOL["bfloat16"]
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 8)
    out = {"shape": shp, "tolerance": {"o": [rtol, atol],
                                       "lse": chip_smoke.LSE_TOL},
           "ptxas": ptxas, "checks": {}, "ms": {}}
    # the check's draw (scores of std 2), under gemma2-2b's masks
    q, k, v = chip_smoke._qkv(torch, gen, dev, torch.bfloat16,
                              qk_std=math.sqrt(2.0), **shp)
    for window in (shp["window"], 96):
        want, wlse = flash_attention_ref(q, k, v, None, True, window,
                                         shp["softcap"])
        for name in libs:
            o, lse = run(name, q, k, v, window, shp["softcap"])
            torch.cuda.synchronize()
            out["checks"][f"{name}/window_{window}"] = {
                "o": _gap(o.float(), want.float(), rtol, atol),
                "lse": _gap(lse, wlse, *chip_smoke.LSE_TOL)}
    # the timing draw of chip_smoke's phases 8 and 12
    q, k, v = chip_smoke._qkv(torch, gen, dev, torch.bfloat16, **shp)
    order = ["committed", *VARIANTS, *reversed(VARIANTS), "committed"]
    for softcap in (shp["softcap"], None):
        key = f"softcap_{softcap}"
        for name in order:
            t = chip_smoke.time_ms(lambda: run(name, q, k, v, shp["window"],
                                               softcap))["median"]
            out["ms"].setdefault(key, {}).setdefault(name, []).append(t)
    _build._libs[LIB] = committed
    out["device"] = chip_smoke.smi_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
