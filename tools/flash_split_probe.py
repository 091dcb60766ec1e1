#!/usr/bin/env python3
"""On-card evidence for the split of P in the sm90 flash forward.

``csrc/flash_fwd_sm90.cu`` multiplies P.V with P carried as two bf16
halves (hi = bf16(P), lo = bf16(P - hi)), two ``wgmma`` per 16 keys.  This
script builds a variant of that source with the lo product removed (P
rounded once to bf16), then at the serving shape (B 4, Hq 16, Hkv 2,
L 2048, D 128, causal, bf16) counts the outputs that each kernel puts
beyond the chip check's bf16 tolerance (``chip_smoke.FLASH_TOL``) against
the plain f32 version, for q, k of std sqrt(2) (the check's draw) and of
std 1/2 (the timing draw), and times both in turns (kernel, variant,
variant, kernel) as ``chip_smoke.time_ms`` does.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/flash_split_probe.py

It prints one JSON line; the variant's library is built under
``build/flash_split_probe/``.
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
LO_PRODUCT = "        wgmma_rs(o, lo[t], d);\n"


def build_variant(_build) -> ctypes.CDLL:
    """The sm90 forward with P rounded once to bf16, built and bound like
    the committed library."""
    out = ROOT / "build" / "flash_split_probe"
    csrc = out / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, csrc)
    src = csrc / "flash_fwd_sm90.cu"
    text = src.read_text()
    if text.count(LO_PRODUCT) != 1:
        raise RuntimeError("the lo product of P.V is not where expected")
    src.write_text(text.replace(LO_PRODUCT, ""))
    lib = out / "libflash_fwd_sm90_one_bf16_p.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    cdll = ctypes.CDLL(str(lib))
    for entry, argtypes in _build.SOURCES["flash_fwd_sm90"].items():
        fn = getattr(cdll, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    cdll.repro_error_string.argtypes = [ctypes.c_int]
    cdll.repro_error_string.restype = ctypes.c_char_p
    return cdll


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_split_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import flash_attention_ref
    FA = importlib.import_module("repro_torch.kernels.flash_attention")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"split": _build.load("flash_fwd_sm90"),
            "one_bf16_p": build_variant(_build)}

    def run(name, q, k, v):
        _build._libs["flash_fwd_sm90"] = libs[name]
        return FA._launch(q, k, v, 1.0 / math.sqrt(q.shape[-1]), True, None,
                          None, route="sm90")[0]

    rtol, atol = chip_smoke.FLASH_TOL["bfloat16"]
    shp = chip_smoke.FLASH_MAIN
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 7)
    out = {"shape": shp, "tolerance": [rtol, atol], "violations": {},
           "max_abs_err": {}, "ms": {}}
    for std in (math.sqrt(2.0), 0.5):
        q, k, v = chip_smoke._qkv(torch, gen, dev, torch.bfloat16,
                                  qk_std=std, **shp)
        want = flash_attention_ref(q, k, v)[0].double()
        for name in libs:
            d = (run(name, q, k, v).double() - want).abs()
            key = f"{name}/qk_std_{std:.4g}"
            out["violations"][key] = int((d > atol + rtol * want.abs())
                                         .sum())
            out["max_abs_err"][key] = float(d.max())
        out["outputs"] = want.numel()
    for name in ("split", "one_bf16_p", "one_bf16_p", "split"):
        t = chip_smoke.time_ms(lambda: run(name, q, k, v))["median"]
        out["ms"].setdefault(name, []).append(t)
    _build._libs["flash_fwd_sm90"] = libs["split"]
    out["device"] = chip_smoke.smi_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
