#!/usr/bin/env python3
"""On-card comparison of the 3xTF32 f32 flash backward with the designs it
was chosen over.

Beside the committed ``csrc/flash_bwd_f32tc.cu``, this script builds
variants from patched copies of the sources under
``build/flash_bwd_f32tc_probe/``: dq with a pair of warps on each 16 q rows
at head_dim 128 too (``dq_paired``: S in one warp, dP in the other, dQ
split by columns, 64 rows a CTA, as the committed kernel runs head_dim
256), dkv over 32-row q tiles at head_dim 128 (``dkv_bq32``), the
accumulators summed in the tensor core across the whole sequence
(``running_accumulator``) instead of each tile's products summed from
zero and folded in with one rounding, and the kernels with one TF32
product instead of three (hi*hi alone), which shows what the split buys.
Each patch must match the committed source exactly once, so a source that
has moved on stops the script instead of timing something else.  It
reports each build's ``ptxas -v`` registers and spills, counts the outputs
each puts beyond the chip check's f32 gradient tolerance
(``chip_smoke.BWD_TOL``) against the plain versions at the training shape
(``chip_smoke.FLASH_TRAIN``) and at gemma2-2b's (``chip_smoke.FLASH_GEMMA2``)
in f32 with scores of std 2, and times all of them in turns (committed,
variants, the CUDA-core kernels, variants reversed, committed), as
``chip_smoke.time_ms`` does.

Run from the repository root on a machine with an H100 and ``nvcc``:

    python3 tools/flash_bwd_f32tc_probe.py

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
LIB = "flash_bwd_f32tc"
#: variant -> (old, new) replacements in the kernels' source
VARIANTS = {
    "dq_paired": [
        ("constexpr bool kPair = DP > 128;", "constexpr bool kPair = true;")],
    "dkv_bq32": [
        ("if (p.D <= 128) return launch_one<128, 32, 64>(dq, p, bh, st);",
         "if (p.D <= 128) return launch_one<128, 32, 32>(dq, p, bh, st);")],
    "running_accumulator": [
        ("      mma3<GO>(part, ah, al, bh, bl);",
         "      mma3<GO>(acc + n0, ah, al, bh, bl);"),
        ("      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];",
         "      for (int e = 0; e < 4; ++e) (void)part[n][e];")],
    "one_tf32_product": [
        ("#pragma unroll\n"
         "  for (int n = 0; n < G; ++n) mma(c[n], al, bh[n]);\n",
         "  // no lo*hi products\n"),
        ("#pragma unroll\n"
         "  for (int n = 0; n < G; ++n) mma(c[n], ah, bl[n]);\n",
         "  // no hi*lo products\n")],
}


def build_variant(_build, name, patches) -> tuple:
    """The kernels built from a copy of ``csrc/`` with ``patches``
    applied, bound like the committed library; with its ``ptxas -v``
    log."""
    out = ROOT / "build" / "flash_bwd_f32tc_probe" / name
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
        print("flash_bwd_f32tc_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import (flash_attention_dkv_ref,
                                         flash_attention_dq_ref,
                                         flash_attention_ref)
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

    def run(name, kind, args):
        q, k = args[0], args[1]
        outs = ((torch.empty_like(q),) if kind == "dq" else tuple(
            torch.empty((*q.shape[:2], k.shape[2], q.shape[3]),
                        device=q.device) for _ in range(2)))
        if name != "simt":
            _build._libs[LIB] = libs[name]
        FA._launch_bwd(kind, outs, *args,
                       route="simt" if name == "simt" else "f32tc")
        return outs

    rtol, atol = chip_smoke.BWD_TOL["float32"]
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 10)
    out = {"tolerance": [rtol, atol], "ptxas": ptxas, "checks": {},
           "ms": {}}
    for key, shp in (("training", chip_smoke.FLASH_TRAIN),
                     ("gemma2", chip_smoke.FLASH_GEMMA2)):
        masks = (shp["causal"], shp["window"], shp["softcap"])
        # the check's draw (scores of std 2), then the timing draw of
        # chip_smoke's phase 12
        for draw in ("check", "time"):
            q, k, v = chip_smoke._qkv(
                torch, gen, dev, torch.float32,
                **({**shp, "qk_std": math.sqrt(2.0)} if draw == "check"
                   else shp))
            scale = 1.0 / math.sqrt(q.shape[-1])
            o, lse = flash_attention_ref(q, k, v, scale, *masks)
            do = 0.5 * torch.randn(q.shape, generator=gen, device=dev)
            args = (q, k, v, do, lse, (do * o).sum(-1), scale, *masks)
            del o
            if draw == "check":
                want = {"dq": (flash_attention_dq_ref(*args),),
                        "dkv": flash_attention_dkv_ref(*args)}
                for name in libs:
                    for kind in ("dq", "dkv"):
                        got = run(name, kind, args)
                        torch.cuda.synchronize()
                        out["checks"][f"{key}/{name}/{kind}"] = [
                            _gap(a, b, rtol, atol)
                            for a, b in zip(got, want[kind])]
                del want
                continue
            order = ["committed", *VARIANTS, "simt", *reversed(VARIANTS),
                     "committed"]
            for name in order:
                for kind in ("dq", "dkv"):
                    t = chip_smoke.time_ms(lambda: run(name, kind, args))
                    out["ms"].setdefault(f"{key}/{kind}", {}).setdefault(
                        name, []).append(t["median"])
            del q, k, v, do, lse, args
            torch.cuda.empty_cache()
    _build._libs[LIB] = committed
    out["device"] = chip_smoke.smi_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
