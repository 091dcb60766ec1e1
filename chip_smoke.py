#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, each printing one JSON line:

0. device probe (torch, CUDA, nvcc, card, power limit);
1. kernel build from ``src/repro_torch/kernels/csrc`` (``nvcc``, sm_90a);
2. every kernel against its plain PyTorch version on the card, bit-exact:
   the unit sweeps, the main path's shapes (``pack_rows`` also as the main
   path calls it, ``ops.pack_tables`` on host-checked tables into an
   unfilled output, and on a plan that leaves rows uncovered, which must
   come out zero), and the 3-D merge world;
3. the main path at full size: a WarpX-style 2-D field output step (six
   8192 x 8192 f32 components in 256 x 256 blocks over 48 load-balanced
   processes) written through ``Dataset.write`` and read back through
   ``Dataset.read`` under ``merged_process`` and ``reorganized``, each
   component compared with its source, plus one partial-region read on
   the region route (one ``pack_rows`` launch) and, for its stages, on
   the host route it replaced;
4. kernel times at the main path's shapes (CUDA events around runs of
   20 back-to-back calls, median of 5 runs),
   beside the memory-bandwidth bound, the plain version and one PyTorch
   call computing the same function; ``pack_rows`` as its kernel, its
   public wrapper and ``pack_tables`` as the main path calls it;
5. launch counts of the main-path run; every kernel must have run (the
   summary's copy-kernel rows add the launches of phases 15, 16, 17a and
   17b);
6. the flash-attention forward's kernels against their plain version on
   the card, within tolerance: masks, GQA groups, head dims 16-256
   (padded ones too), ragged lengths, f32 and bf16, the serving paths'
   shapes (qwen2.5-3b's in bf16 and f32, gemma2-2b's) with scores of std
   2, and two more bf16 cases (D 80 at L 200; D 128 at L 2048 with a
   window of 512 and a softcap); the launch counts show that each bf16
   case ran the sm90 route (``csrc/flash_fwd_sm90.cu`` up to head_dim
   128, ``csrc/flash_fwd_sm90_d256.cu`` above) and each f32 case the
   3xTF32 tensor-core kernel (``csrc/flash_fwd_f32tc.cu``), each route's
   total equal to the cases sent to it; the CUDA-core kernel
   (``csrc/flash_fwd.cu``), named, on the f32 serving shape;
7. the serving path at full width: ``ServeEngine.generate`` on
   qwen2.5-3b (36 layers, random weights from a seed, attention
   projections at true fan-in: see ``serving_params``) with the flash
   route on, 4 prompts of 2048 tokens and 32 greedy new tokens, launch
   counts reset just before it and read just after; then its prefill
   logits against the q-chunked route's on the same weights (bf16 and
   f32 compute, each flash prefill's launch counts read on their own: the
   bf16 one runs the sm90 kernel, the f32 one the 3xTF32 kernel), and a
   profile of prefill and decode;
8. flash-attention forward times at the serving and training shapes and
   at gemma2-2b's (as phase 4's): the sm90 route's kernel beside its
   bound, the CUDA-core kernel on the same bf16 inputs, the plain version
   and ``scaled_dot_product_attention`` (gemma2-2b's also without the
   softcap, which SDPA lacks); and on f32 inputs at the same three shapes
   the 3xTF32 kernel beside the CUDA-core kernel on the same inputs, both
   bounds (three TF32 products at the TF32 peak, and f32 on the CUDA
   cores), the plain version and SDPA in f32;
9. launch counts of the serving run; the sm90 kernel must have run once
   per layer at least, the head_dim-256, 3xTF32 and CUDA-core forwards
   never;
10. the flash-attention backward kernels (dQ, and per-q-head dK, dV)
    against their plain versions on the card, within tolerance, over the
    forward's sweep, the training shape and gemma2-2b's full-length shape
    given as strided views in bf16 and in f32 (the training shape's f32
    inputs also on the CUDA-core route, named), and
    ``flash_attention``'s gradients against autograd through the plain
    forward; the launch counts show that each bf16 case ran the sm90
    kernels (``csrc/flash_bwd_sm90.cu`` up to head_dim 128,
    ``csrc/flash_bwd_sm90_d256.cu`` above) and each f32 case the 3xTF32
    ones (``csrc/flash_bwd_f32tc.cu``), the named case the CUDA-core ones
    (``csrc/flash_bwd.cu``), and each route's count equals the cases the
    sweep sends it;
11. the training path at full width: qwen2.5-3b (36 layers, random
    weights from a seed: see ``training_params``; ``remat="dots"``) with
    the flash route on, at
    global batch 2 x 2048 tokens from the synthetic pipeline: first the
    flash route's loss and gradients against the q-chunked route's (f32
    and bf16 compute; the bf16 route's backward runs the sm90 kernels, the
    f32 one the 3xTF32 kernels after the 3xTF32 forward), then
    ``Trainer.run`` for 6 AdamW steps
    on one batch (``TRAIN_OPT``), launch counts reset just before it and
    read just after (36 sm90 dq and 36 sm90 dkv launches a step, none on
    the CUDA-core route), the step times, peak memory, and a profile of
    one more step;
12. the backward kernels' times (as phase 4's): at the training shape and
    at gemma2-2b's bf16 head_dim-256 shape the sm90 kernels beside the
    CUDA-core kernels on the same bf16 inputs, their bound, the plain
    versions and the backward of ``scaled_dot_product_attention`` (its
    kernels' device time from the profiler: autograd's host work outlasts
    them); and at both shapes on f32 inputs, those of the f32 route
    comparisons, the 3xTF32 kernels beside the CUDA-core ones, both
    bounds (3xTF32 and f32 on the CUDA cores) and SDPA's backward in f32;
13. the serving path at gemma2-2b's full width (26 layers, head_dim 256,
    local and global layers, softcaps; random weights: see
    ``training_params``), as phase 7 serves qwen2.5-3b: the bf16 prefill
    launches the sm90 route's head_dim-256 kernel once per layer and the
    CUDA-core forward never, the f32 route comparison the 3xTF32 forward
    once per layer, and the profile names the flash forward's device time
    in the prefill;
14. the training path at gemma2-2b's full width, as phase 11 trains
    qwen2.5-3b (the same traffic, steps and checks): 26 launches a step
    of each head_dim-256 sm90 backward kernel
    (``csrc/flash_bwd_sm90_d256.cu``), 52 of the head_dim-256 forward,
    none on a CUDA-core route; the f32 route comparison runs the 3xTF32
    forward and backward once per layer, and the profile
    names the flash backward's device time in a step;
15. (run right after phase 11, on its trained tree: the later phases have
    no room for it beside their own) the checkpoint path at full width:
    qwen2.5-3b's params and AdamW state (42 f32 leaves, 37 GB, and the
    int32 step count) saved by ``CheckpointManager`` under
    ``merged_process`` into ``build/chip_smoke/ckpt`` from
    ``MeshSharding``s of 2 simulated hosts x 4 devices (each leaf split 8
    ways, the blocks from ``blocks_from_sharding``: 2 chunks a leaf, one
    ``pack_rows`` launch a leaf at least), restored whole onto the card
    (every leaf ``torch.equal``, the count 0-d), restored elastically (the
    embedding and one MLP weight 4 ways on another axis, through the
    region route: one launch a variable, every shard ``torch.equal``, with
    ``reshard_cost_report``'s chunks, runs and amplification), and the
    embedding alone saved and restored under ``reorganized`` (8, 1)
    through ``rowmajor_to_chunked`` and ``chunked_to_rowmajor``; each
    step's launch counts reset just before it and read just after, the
    peak device memory, the free disk, and the directory removed;
16. (after phase 14) post-hoc reorganization on the card (paper §5):
    slice 1's component (8192 x 8192 f32 from ``merged_process``)
    reorganized by ``reorganize`` to ``reorganized`` 8 x 8 (generation 1,
    one ``pack_rows`` launch for the gather, the whole read-back through
    ``chunked_to_rowmajor``, ``verify_checksums`` clean); then a
    WarpX-style 3-D component at the paper's aspect (512 x 1024 x 1024
    f32, 64 x 64 x 128 boxes over the 48 ranks) written under
    ``merged_process``, reorganized out of place to the default 4 x 4 x 4
    (one ``pack_rows`` launch a gather batch), its six Fig.-6 patterns
    read under both layouts by ``Dataset.read`` (``torch.equal`` to the
    source) and by ``read_pattern`` with 8 readers and
    ``engine="auto"`` (best scheme, seconds, bytes, chunks, the engine and
    its reason; the calibration's terms), and reorganized in place to 2 x
    8 x 4 (generation up by one, seen by a session opened before the
    commit after ``refresh``); every whole read-back ``torch.equal``, each
    step's launch counts reset just before it and read just after, the
    directory removed.  Reads come from the page cache.  Between the
    patterns and the in-place step (16c), ``reorganize(layout="auto")`` of
    the component over the history its pattern reads logged to
    ``access_log.json``: the policy's decision (scheme, codec, reason,
    scores), the stage seconds, the launches (one a gather batch and one
    for the codec sample's read) and the whole read-back; that history is
    exported as 17a's prior;
17a. online reorganization (paper §5, the staging coupler): the same 3-D
    component as 1,024 boxes of a field on the card, staged for 3 output
    steps by ``StagingExecutor`` (2 workers, queue depth 2,
    ``engine="auto"``) under ``plan="auto"`` with 16c's prior, while the
    producer advances the field in place on its own stream after each
    submit; per step ``t_s`` (with its lowering, kernel and d2h), ``t_w``,
    the stall, bytes, chunks, engine and reason; the policy's decision;
    the §5.2 recommendation for the measured producer step; the launches
    (``pack_rows`` one a step at least: the layout is assembled on the
    card); the peak device memory; every step read back ``torch.equal``
    to the field as it was at its submit;
17b. async checkpoints at full width: qwen2.5-3b trained for 2 steps by
    ``Trainer.run`` with an ``AsyncCheckpointer`` (``reorganized`` (4,
    4), 1 worker, queue depth 1) as its checkpoint manager, which stages
    the params (14 f32 leaves, 12.3 GB) after each step; per save the
    stall, ``t_s``, ``t_w`` and stages, the recommendation (the direct
    write: phase 15's save of the same leaves), the launches of the run,
    the peak memory; every staged leaf read back ``torch.equal`` to a host
    copy of the params at its save; the directory removed.

The last lines are the script's total seconds, the kernel summary, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; without a CUDA device the script exits
non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet), flop/s
BF16_FLOPS = 989e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
F32_FLOPS = 67e12
#: H100 SXM dense TF32 tensor-core rate (NVIDIA data sheet); the 3xTF32
#: forward does three TF32 products for each useful one
TF32_FLOPS = 495e12
TF32X3_FLOPS = TF32_FLOPS / 3

FIELD = (8192, 8192)
BLOCK = (256, 256)
NPROCS, PPN = 48, 6             # 6 ranks per node, as the 3-D benchmark
COMPONENTS = ("Ex", "Ey", "Ez", "Bx", "By", "Bz")
SEED = 0
REPS = 20

#: the serving path: qwen2.5-3b, 4 prompts of 2048 tokens, 32 new tokens;
#: gemma2-2b (head_dim 256) serves the same traffic
SERVE_ARCH, GEMMA2_ARCH = "qwen2.5-3b", "gemma2-2b"
SERVE_BATCH, PROMPT_LEN, NEW_TOKENS = 4, 2048, 32
#: flash attention at the serving path's shape, and at gemma2-2b's (its
#: config's window of 4096 and softcap of 50; head_dim 256); their
#: check draws q and k with std sqrt(2), so the scores have std 2 and the
#: online softmax's rescaling across k tiles carries real weight
FLASH_MAIN = dict(B=4, Hq=16, Hkv=2, L=2048, D=128, causal=True,
                  window=None, softcap=None)
FLASH_GEMMA2 = dict(B=4, Hq=8, Hkv=4, L=2048, D=256, causal=True,
                    window=4096, softcap=50.0)
#: (rtol, atol) on O per input dtype, and the LSE's.  f32: the reference's
#: own.  bf16: kernel and plain version both compute in f32 and round once
#: to bf16, so they may differ by one bf16 step, at most 2^-7 of |O|; the
#: atol covers f32 rounding where O cancels to near zero
FLASH_TOL = {"float32": (1e-4, 1e-5), "bfloat16": (2.0 ** -7, 1e-5)}
#: two more bf16 checks on the sm90 route: a padded head dim (80 -> 128) at
#: ragged L 200, and the serving length under a one-sided window and a
#: softcap (the masks' tile-by-tile path at full length)
FLASH_D80 = dict(B=2, Hq=8, Hkv=2, L=200, D=80, causal=True, window=None,
                 softcap=None)
FLASH_LONG_WINDOW = dict(B=1, Hq=16, Hkv=2, L=2048, D=128, causal=True,
                         window=512, softcap=30.0)
#: the flash kernels' routes (``flash_attention._route``); ``flash_kernel``
#: names each route's kernel for a head dim
FLASH_ROUTES = ("sm90", "f32tc", "simt")
LSE_TOL = (1e-4, 1e-4)
#: flash vs q-chunked prefill logits: max |d| / max |q-chunked|
LOGIT_GAP = 2e-2
#: (rtol, atol) on the backward kernels' outputs per input dtype.  f32: the
#: reference's gradient tolerance.  bf16: dQ is rounded once to bf16 from
#: an f32 sum in both versions, so one bf16 step (2^-7 of |dQ|); the
#: per-q-head dK, dV are f32 in both and are held to the f32 tolerance
BWD_TOL = {"float32": (1e-3, 1e-4), "bfloat16": (2.0 ** -7, 1e-4)}

#: the training path: qwen2.5-3b, global batch 2 x 2048 tokens, 6 steps
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 6
#: AdamW for the training run.  Its first steps move each of the 3.1e9
#: weights by about lr whatever its gradient's size; with a 2-step warmup
#: to 3e-4 the loss went 12.25, 8.91, 16.65, 16.39, 17.93, 13.68 on the
#: flash route and 12.25, 8.91, 16.70, 16.43, 17.89, 14.10 on the
#: q-chunked route (an H100 80GB HBM3 at 700 W, tools/train_lr_probe.py):
#: AdamW's overshoot, not the kernels'.  A 100-step warmup to the same
#: peak went 12.25 -> 7.63.
TRAIN_OPT = dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000)
FLASH_TRAIN = dict(B=TRAIN_BATCH, Hq=16, Hkv=2, L=TRAIN_SEQ, D=128,
                   causal=True, window=None, softcap=None)
#: flash vs q-chunked training gradients in f32: max |d| / max |q-chunked|
#: per leaf; the loss in bf16 compute: |d| / |q-chunked|
GRAD_GAP_F32, LOSS_GAP_BF16 = 1e-3, 1e-2

KERNELS = {
    "pack_rows": ("src/repro_torch/kernels/csrc/pack_rows.cu",
                  "src/repro/kernels/pack_blocks.py:29"),
    "chunked_to_rowmajor": ("src/repro_torch/kernels/csrc/relayout.cu",
                            "src/repro/kernels/relayout.py:22"),
    "rowmajor_to_chunked": ("src/repro_torch/kernels/csrc/relayout.cu",
                            "src/repro/kernels/relayout.py:26"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_fwd_sm90.cu",
                        "src/repro/kernels/flash_attention.py:39"),
    "flash_attention_d256": (
        "src/repro_torch/kernels/csrc/flash_fwd_sm90_d256.cu",
        "src/repro/kernels/flash_attention.py:39"),
    "flash_attention_f32tc": (
        "src/repro_torch/kernels/csrc/flash_fwd_f32tc.cu",
        "src/repro/kernels/flash_attention.py:39"),
    "flash_attention_simt": ("src/repro_torch/kernels/csrc/flash_fwd.cu",
                             "src/repro/kernels/flash_attention.py:39"),
    "flash_attention_dq": ("src/repro_torch/kernels/csrc/flash_bwd_sm90.cu",
                           "src/repro/kernels/flash_attention.py:146"),
    "flash_attention_dq_d256": (
        "src/repro_torch/kernels/csrc/flash_bwd_sm90_d256.cu",
        "src/repro/kernels/flash_attention.py:146"),
    "flash_attention_dq_f32tc": (
        "src/repro_torch/kernels/csrc/flash_bwd_f32tc.cu",
        "src/repro/kernels/flash_attention.py:146"),
    "flash_attention_dq_simt": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                                "src/repro/kernels/flash_attention.py:146"),
    "flash_attention_dkv": ("src/repro_torch/kernels/csrc/flash_bwd_sm90.cu",
                            "src/repro/kernels/flash_attention.py:166"),
    "flash_attention_dkv_d256": (
        "src/repro_torch/kernels/csrc/flash_bwd_sm90_d256.cu",
        "src/repro/kernels/flash_attention.py:166"),
    "flash_attention_dkv_f32tc": (
        "src/repro_torch/kernels/csrc/flash_bwd_f32tc.cu",
        "src/repro/kernels/flash_attention.py:166"),
    "flash_attention_dkv_simt": ("src/repro_torch/kernels/csrc/flash_bwd.cu",
                                 "src/repro/kernels/flash_attention.py:166"),
}
FLASH_KERNELS = [n for n in KERNELS if n.startswith("flash_attention")]


def flash_kernel(kind: str, route: str, head_dim: int) -> str:
    """The launch counter of the flash kernel ``kind`` (``"fwd"``,
    ``"dq"`` or ``"dkv"``) that ``route`` runs at ``head_dim``: the sm90
    route's head_dim-256 kernels above 128."""
    name = "flash_attention" + ("" if kind == "fwd" else f"_{kind}")
    if route in ("simt", "f32tc"):
        return f"{name}_{route}"
    return name + ("_d256" if head_dim > 128 else "")


def flash_deltas(before: dict, after: dict) -> dict:
    """Each flash kernel's launches between two ``launch_counts()``."""
    return {n: after[n] - before[n] for n in FLASH_KERNELS}


def emit(phase, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def max_abs_err(a, b) -> float:
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    if not torch.equal(a, b):
        raise AssertionError("kernel and plain version differ: "
                             f"{(a.double() - b.double()).abs().max()}")
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def close_err(a, b, rtol: float, atol: float) -> float:
    """The largest |a - b|; raises where |a - b| > atol + rtol * |b|."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
    d = (a.double() - b.double()).abs()
    bad = d > atol + rtol * b.double().abs()
    if bad.any() or not torch.isfinite(a).all():
        raise AssertionError(f"kernel and plain version differ beyond rtol "
                             f"{rtol} / atol {atol}: {int(bad.sum())} of "
                             f"{a.numel()}, max {float(d.max())}")
    return float(d.max()) if a.numel() else 0.0


def time_ms(fn, reps: int = REPS, rounds: int = 5) -> dict:
    """Device time of one call: CUDA events around ``rounds`` runs of
    ``reps`` back-to-back calls after a warm-up, each run divided by
    ``reps``, so the host's work between launches (the wrapper's checks,
    allocation, tensor maps) overlaps the device's and is not counted as
    the kernel's: the median and the quartiles, in milliseconds."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    q1, med, q3 = statistics.quantiles(times, n=4)
    return {"median": med, "p25": q1, "p75": q3}


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call: the summed device time of its kernels
    under ``torch.profiler`` over ``reps`` calls after a warm-up, per call.
    For a call whose host work outlasts its kernels (autograd's backward),
    where events would time the host."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


# -- phase 0 / 1 ---------------------------------------------------------------

def probe(torch) -> dict:
    from repro_torch.kernels import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    cap = torch.cuda.get_device_capability(0)
    info = {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": nvcc.strip().splitlines()[-1],
            "device": torch.cuda.get_device_name(0),
            "capability": list(cap), "count": torch.cuda.device_count(),
            "nvidia_smi": smi_line()}
    if cap != (9, 0):
        raise RuntimeError(f"the kernels are built for sm_90a; this card is "
                           f"sm_{cap[0]}{cap[1]}")
    return info


def ptxas_report(log: str) -> dict:
    """``ptxas -v``'s report on one library: its entry functions, the most
    registers any uses, and each one that spills with its spill stores and
    loads in bytes (names demangled where ``c++filt`` is found)."""
    regs, spills, entry = [], {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln and entry:
            n = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            if n[1] or n[2]:
                spills[entry] = n[1:3]
        elif "Used" in ln and "registers" in ln and entry:
            regs.append(int(ln.split("Used")[1].split()[0]))
    if spills and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(spills),
                               capture_output=True, text=True).stdout
        spills = dict(zip(names.split("\n"), spills.values()))
    return {"entries": len(regs), "max_registers": max(regs, default=0),
            "spills": spills}


def build() -> dict:
    """Build and load every library; the tensor-core kernels, sized to
    their register budget, must not spill."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    info = _build.build_all()
    for name in _build.SOURCES:
        _build.load(name)
    libs = {n: {"seconds": v["seconds"], "ptxas": ptxas_report(v["log"])}
            for n, v in info.items()}
    for n, v in libs.items():
        if n.endswith(("_sm90", "_sm90_d256", "_f32tc")) and \
                v["ptxas"]["spills"]:
            raise RuntimeError(f"{n} spills: {v['ptxas']['spills']}")
    return {"seconds": time.perf_counter() - t0, "libs": libs}


# -- phase 2 -------------------------------------------------------------------

def _rows_case(rng, n, w, torch, dtype, dev):
    src = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32))
    if dtype in (torch.int32, torch.int8):
        src = (src * 50).round().clamp(-128, 127)
    src = src.to(dtype).to(dev)
    perm = rng.permutation(n).astype(np.int32)
    m = n + 8
    dst = rng.choice(m, size=n, replace=False).astype(np.int32)
    return (src, torch.from_numpy(perm).to(dev),
            torch.from_numpy(dst).to(dev), m)


def slice_tables(layout):
    """Row tables of the main path's merged write of one component."""
    from repro_torch.core.clustering import Cluster
    from repro_torch.core.merge import plan_from_clusters
    from repro_torch.kernels.ref import plan_row_tables
    plan = plan_from_clusters([Cluster(cp.chunk, tuple(cp.sources))
                               for cp in layout.chunks])
    return plan_row_tables(plan)


def check_kernels(torch, dev, layout) -> dict:
    from repro_torch.core import (build_merge_plan, simulate_load_balance,
                                  uniform_grid_blocks)
    from repro_torch.core.blocks import Block
    from repro_torch.core.clustering import Cluster
    from repro_torch.core.merge import plan_from_clusters
    from repro_torch.kernels import (chunked_to_rowmajor,
                                     merge_blocks_device, pack_rows,
                                     rowmajor_to_chunked)
    from repro_torch.kernels.ops import pack_tables
    from repro_torch.kernels.ref import (chunked_to_rowmajor_ref,
                                         pack_rows_ref,
                                         rowmajor_to_chunked_ref)
    cases = 0
    err = {k: 0.0 for k in KERNELS}
    rng = np.random.default_rng(SEED)
    # the unit sweep, plus row lengths that take every vector width
    # (12, 8, 6 and 7 bytes: 4-, 8-, 2- and 1-byte accesses)
    sweep = [(dt, n, w) for dt in (torch.float32, torch.bfloat16,
                                   torch.int32, torch.int8)
             for n, w in ((32, 128), (64, 256), (16, 512))]
    sweep += [(torch.float32, 40, 3), (torch.int32, 40, 2),
              (torch.bfloat16, 40, 3), (torch.int8, 40, 7)]
    for dt, n, w in sweep:
        src, sr, dr, m = _rows_case(rng, n, w, torch, dt, dev)
        got = pack_rows(src, sr, dr, n_dst_rows=m, width=w)
        max_abs_err(got, pack_rows_ref(src, sr, dr, n_dst_rows=m, width=w))
        cases += 1
    # the checkpoint-merge case: row-slab shards of a 2-D weight
    W = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    shards = [(32, 48), (0, 16), (48, 64), (16, 32)]
    src = torch.cat([W[a:b] for a, b in shards]).to(dev)
    dst_rows = np.concatenate([np.arange(a, b) for a, b in shards])
    got = pack_rows(src, torch.arange(64, dtype=torch.int32, device=dev),
                    torch.from_numpy(dst_rows.astype(np.int32)).to(dev),
                    n_dst_rows=64, width=256)
    max_abs_err(got, W.to(dev))
    cases += 1

    for dt in (torch.float32, torch.bfloat16):
        for grid, chunk in (((4, 2), (8, 128)), ((2, 4), (16, 128)),
                            ((3, 3), (8, 256))):
            x = torch.from_numpy(rng.standard_normal(
                (*grid, *chunk)).astype(np.float32)).to(dt).to(dev)
            rm = chunked_to_rowmajor(x, chunk=chunk)
            max_abs_err(rm, chunked_to_rowmajor_ref(x))
            back = rowmajor_to_chunked(rm, chunk=chunk)
            max_abs_err(back, rowmajor_to_chunked_ref(rm, chunk))
            max_abs_err(back, x)
            cases += 3

    # the main path's shapes: the merged write of one component, and the
    # 8 x 8 grid of 1024 x 1024 chunks of the reorganized layout
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    width, sr, dr, total, _ = slice_tables(layout)
    src = torch.randn(total, generator=gen, device=dev)
    sr_t, dr_t = (torch.from_numpy(a).to(dev) for a in (sr, dr))
    kw = dict(n_dst_rows=total // width, width=width)
    want = pack_rows_ref(src, sr_t, dr_t, **kw)
    err["pack_rows"] = max_abs_err(pack_rows(src, sr_t, dr_t, **kw), want)
    # as the main path calls it: the numpy tables checked on the host, the
    # output left unfilled (they name every row), in memory the allocator
    # has just handed out full of NaN
    torch.full((total,), float("nan"), device=dev)
    max_abs_err(pack_tables(src, slice_tables(layout), _covered=True),
                want.reshape(-1))
    # a plan whose cluster holds rows no block names: they come out zero,
    # though the allocator hands out memory full of NaN
    holey = plan_from_clusters([Cluster(
        Block((0, 0), (64, 96)),
        (Block((0, 0), (32, 64), block_id=0),
         Block((32, 32), (64, 96), block_id=1)))])
    parts = {b: torch.randn((32, 64), generator=gen, device=dev)
             for b in (0, 1)}
    ref = torch.zeros((64, 96), device=dev)
    ref[:32, :64], ref[32:, 32:] = parts[0], parts[1]
    torch.full((64 * 96,), float("nan"), device=dev)
    (got,) = merge_blocks_device(holey, parts)
    max_abs_err(got, ref)
    cases += 2
    del want, got
    x = torch.randn((8, 8, 1024, 1024), generator=gen, device=dev)
    rm = chunked_to_rowmajor(x, chunk=(1024, 1024))
    err["chunked_to_rowmajor"] = max_abs_err(rm, chunked_to_rowmajor_ref(x))
    back = rowmajor_to_chunked(rm, chunk=(1024, 1024))
    err["rowmajor_to_chunked"] = max_abs_err(
        back, rowmajor_to_chunked_ref(rm, (1024, 1024)))
    max_abs_err(back, x)
    cases += 4
    del src, sr_t, dr_t, x, rm, back

    # merge_blocks_device on the 3-D world: 256^3 f32, 32x32x64 blocks, 48
    # load-balanced processes (64-element rows: N-D row tables)
    blocks = simulate_load_balance(uniform_grid_blocks((256, 256, 256),
                                                       (32, 32, 64)),
                                   num_procs=48, seed=SEED)
    merged = 0
    for p in range(48):
        mine = [b for b in blocks if b.owner == p]
        if not mine:
            continue
        plan = build_merge_plan(mine)
        data = {b.block_id: torch.randn(b.shape, generator=gen, device=dev)
                for b in mine}
        ref = [torch.empty(c.cuboid.shape, device=dev) for c in plan.clusters]
        for op in plan.copies:
            ref[op.dst_index][op.dst_slices] = data[op.block_id]
        for a, b in zip(merge_blocks_device(plan, data), ref):
            max_abs_err(a, b)
        merged += len(plan.clusters)
        cases += 1
    torch.cuda.synchronize()
    return {"cases": cases, "merged_buffers_3d": merged,
            "tolerance": "bit-exact: torch.equal, max_abs_err 0",
            "max_abs_err": err}


# -- phase 3 -------------------------------------------------------------------

def main_path(torch, dev, blocks, layouts) -> dict:
    from repro_torch.core.blocks import Block
    from repro_torch.io import Dataset
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fields = {c: torch.randn(FIELD, generator=gen, device=dev)
              for c in COMPONENTS}
    # every block its own allocation, as a WarpX FArrayBox
    data = {c: {b.block_id: fields[c][b.slices()].contiguous()
                for b in blocks} for c in COMPONENTS}
    torch.cuda.synchronize()
    whole = Block((0, 0), FIELD)
    part = Block((FIELD[0] // 8, FIELD[1] * 3 // 8),
                 (FIELD[0] * 5 // 8, FIELD[1] * 7 // 8))
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, layout in layouts.items():
        st = dict.fromkeys(("plan", "lower_write", "kernel", "d2h",
                            "engine_write", "engine_read", "lower_read",
                            "h2d", "linearize", "checksum_and_index"), 0.0)
        st["plan"] = layout["plan_seconds"]
        d = tempfile.mkdtemp(dir=work)
        try:
            ds = Dataset.create(d)
            for c in COMPONENTS:
                t0 = time.perf_counter()
                plan = ds.plan_write(c, layout["plan"], np.float32)
                st["plan"] += time.perf_counter() - t0
                ws = ds.write_planned(plan, data[c])
                st["lower_write"] += ws.lower_seconds
                st["kernel"] += ws.kernel_seconds
                st["d2h"] += ws.d2h_seconds
                st["engine_write"] += ws.write_seconds
                st["checksum_and_index"] += (ws.total_seconds
                                             - ws.assemble_seconds
                                             - ws.write_seconds)
            ds.close()
            ds = Dataset.open(d)
            for c in COMPONENTS:
                got, rs = ds.read(c, whole)
                if got.device != dev or not torch.equal(got, fields[c]):
                    raise AssertionError(f"{name}/{c}: read-back differs")
                st["engine_read"] += rs.seconds
                st["lower_read"] += rs.lower_seconds
                st["h2d"] += rs.h2d_seconds
                st["linearize"] += rs.linearize_seconds
                del got
            out[name] = {"part_read": part_read(torch, dev, ds, part,
                                                fields["Ez"])}
            ds.close()
            nbytes = sum(p.stat().st_size for p in Path(d).iterdir())
        finally:
            shutil.rmtree(d)
        out[name].update(chunks=len(layout["plan"].chunks),
                         stored_bytes=nbytes, seconds=st)
    return out


def part_read(torch, dev, ds, part, field) -> dict:
    """A part of one component read onto the card on the region route
    (``Dataset.read``: each touched extent once, one copy, one
    ``pack_rows`` launch), then on the host route it replaced (the host
    plan, then one copy of the result); both held to the source."""
    t0 = time.perf_counter()
    got, rs = ds.read("Ez", part)
    torch.cuda.synchronize()
    region_s = time.perf_counter() - t0
    if not torch.equal(got, field[part.slices()]):
        raise AssertionError("partial read differs (region route)")
    t0 = time.perf_counter()
    arr, hs = ds.read_planned(ds.plan_read("Ez", part))
    t1 = time.perf_counter()
    got = torch.from_numpy(arr).to(dev)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t1
    host_s = time.perf_counter() - t0
    if not torch.equal(got, field[part.slices()]):
        raise AssertionError("partial read differs (host route)")
    return {"region": [list(part.lo), list(part.hi)],
            "chunks_touched": rs.chunks_touched, "bytes": rs.bytes_read,
            "region_route": {"seconds": region_s, "engine_read": rs.seconds,
                             "lower": rs.lower_seconds,
                             "h2d": rs.h2d_seconds,
                             "linearize": rs.linearize_seconds,
                             "bytes_read": rs.bytes_read},
            "host_route": {"seconds": host_s, "engine_read": hs.seconds,
                           "plan": hs.probe_seconds + hs.plan_seconds,
                           "h2d": h2d}}


# -- phase 4 -------------------------------------------------------------------

def timings(torch, dev, layout) -> dict:
    from repro_torch.kernels import pack_blocks, relayout
    from repro_torch.kernels.ops import pack_tables
    from repro_torch.kernels.ref import (chunked_to_rowmajor_ref,
                                         pack_rows_ref,
                                         rowmajor_to_chunked_ref)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    tables = slice_tables(layout)
    width, sr, dr, total, _ = tables
    src = torch.randn(total, generator=gen, device=dev)
    sr_t, dr_t = (torch.from_numpy(a).to(dev) for a in (sr, dr))
    n_dst = total // width
    out = torch.zeros((n_dst, width), device=dev)
    copy_dst = torch.empty_like(src)
    rows = len(sr)
    pack_bytes = 2 * rows * width * 4 + 2 * rows * 4
    res = {"pack_rows": {
        "shape": {"rows": rows, "width": width, "dtype": "float32"},
        "ms": time_ms(lambda: pack_blocks.launch(src, out, sr_t, dr_t,
                                                 width)),
        "wrapper_ms": time_ms(lambda: pack_blocks.pack_rows(
            src, sr_t, dr_t, n_dst_rows=n_dst, width=width)),
        "main_path_ms": time_ms(lambda: pack_tables(src, tables,
                                                    _covered=True)),
        "plain_ms": time_ms(lambda: pack_rows_ref(
            src, sr_t, dr_t, n_dst_rows=n_dst, width=width)),
        "library_ms": time_ms(lambda: copy_dst.copy_(src)),
        "bytes": pack_bytes}}
    del src, out, copy_dst, sr_t, dr_t

    x = torch.randn((8, 8, 1024, 1024), generator=gen, device=dev)
    rm = torch.empty(FIELD, device=dev)
    ch = torch.empty_like(x)
    nbytes = 2 * x.numel() * 4
    res["chunked_to_rowmajor"] = {
        "shape": {"chunks": [8, 8, 1024, 1024], "dtype": "float32"},
        "ms": time_ms(lambda: relayout.launch(x, rm, 8, 8, 1024, 1024,
                                              to_rowmajor=True)),
        "plain_ms": time_ms(lambda: chunked_to_rowmajor_ref(x)),
        "library_ms": time_ms(
            lambda: x.permute(0, 2, 1, 3).contiguous().view(FIELD)),
        "bytes": nbytes}
    res["rowmajor_to_chunked"] = {
        "shape": {"array": list(FIELD), "chunk": [1024, 1024],
                  "dtype": "float32"},
        "ms": time_ms(lambda: relayout.launch(rm, ch, 8, 8, 1024, 1024,
                                              to_rowmajor=False)),
        "plain_ms": time_ms(lambda: rowmajor_to_chunked_ref(rm,
                                                            (1024, 1024))),
        "library_ms": time_ms(
            lambda: rm.view(8, 1024, 8, 1024).permute(0, 2, 1, 3)
            .contiguous()),
        "bytes": nbytes}
    for r in res.values():
        r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
        for key in [k for k in r if isinstance(r[k], dict)
                    and "median" in r[k]]:
            r[f"{key}_quartiles"] = [r[key]["p25"], r[key]["p75"]]
            r[key] = r[key]["median"]
    return res


# -- phase 6 -------------------------------------------------------------------

def _qkv(torch, gen, dev, dtype, B, Hq, Hkv, L, D, Lk=None, qk_std=0.5,
         **_):
    """Seeded q, k, v on the card: v N(0, 1/4) as in the reference's
    sweep, q and k with std ``qk_std`` (scores then have std qk_std^2)."""
    Lk = Lk or L
    return tuple((std * torch.randn(shape, generator=gen, device=dev)
                  ).to(dtype)
                 for std, shape in ((qk_std, (B, Hq, L, D)),
                                    (qk_std, (B, Hkv, Lk, D)),
                                    (0.5, (B, Hkv, Lk, D))))


def _flash_case(torch, q, k, v, causal, window, softcap,
                route=None) -> tuple:
    """Kernel vs plain version: (max |dO|, max |dLSE|, the route that
    ran), raising beyond the tolerances and unless exactly one launch was
    counted, on the kernel of the route ``_route`` picks for these
    inputs (``flash_kernel``), or of ``route`` named through the
    module-private launcher, and none on any other flash kernel."""
    import repro_torch.kernels as K
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    FA = sys.modules["repro_torch.kernels.flash_attention"]
    before = K.launch_counts()
    if route is None:
        o, lse = flash_attention(q, k, v, None, causal, window, softcap,
                                 return_lse=True)
    else:
        o, lse = FA._launch(q, k, v, 1.0 / math.sqrt(q.shape[-1]), causal,
                            window, softcap, route=route)
    after = K.launch_counts()
    route = route or FA._route(q.dtype, q.shape[-1], "fwd")
    ran = flash_deltas(before, after)
    kernel = flash_kernel("fwd", route, q.shape[-1])
    want = {n: int(n == kernel) for n in FLASH_KERNELS}
    if ran != want:
        raise AssertionError(f"{q.dtype} D {q.shape[-1]}: expected {want} "
                             f"launches by route, counted {ran}")
    ro, rlse = flash_attention_ref(q, k, v, None, causal, window, softcap)
    torch.cuda.synchronize()
    rtol, atol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    return (close_err(o.float(), ro.float(), rtol, atol),
            close_err(lse, rlse, *LSE_TOL), route)


def check_flash(torch, dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    masks = {"causal": (True, None, None), "non_causal": (False, None, None),
             "window": (True, 48, None), "softcap": (True, None, 30.0),
             "window_softcap": (False, 48, 30.0)}
    groups: dict = {}
    routes = dict.fromkeys(FLASH_ROUTES, 0)
    expected = dict.fromkeys(FLASH_ROUTES, 0)
    cases = 0
    # lengths that are no multiple of the kernel's 64-row tiles, one case
    # with Lq != Lk, and head dims 24, 48, 136, 200 that run on zero-padded
    # columns (to 32, 64, 256, 256)
    for dtype in (torch.float32, torch.bfloat16):
        for name, (causal, window, softcap) in masks.items():
            worst = [0.0, 0.0]
            for g in (1, 2, 4, 8):
                for D in (16, 24, 32, 48, 80, 128, 136, 200, 256):
                    q, k, v = _qkv(torch, gen, dev, dtype, B=2, Hq=2 * g,
                                   Hkv=2, L=200, D=D,
                                   Lk=136 if g == 2 else None)
                    *e, route = _flash_case(torch, q, k, v, causal, window,
                                            softcap)
                    worst = [max(a, b) for a, b in zip(worst, e)]
                    routes[route] += 1
                    expected["sm90" if dtype == torch.bfloat16
                             else "f32tc"] += 1
                    cases += 1
            groups[f"{name}/{str(dtype).split('.')[-1]}"] = {
                "o": worst[0], "lse": worst[1]}
    shapes = {}
    # bf16 on the sm90 route (gemma2's on its head_dim-256 kernel); f32 at
    # the serving prefill's and gemma2-2b's shapes on the 3xTF32 route; the
    # CUDA-core forward, which no path runs now, named at the serving shape
    for name, shp, dtype, want, named in (
            ("serving", FLASH_MAIN, torch.bfloat16, "sm90", None),
            ("gemma2", FLASH_GEMMA2, torch.bfloat16, "sm90", None),
            ("d80", FLASH_D80, torch.bfloat16, "sm90", None),
            ("long_window", FLASH_LONG_WINDOW, torch.bfloat16, "sm90", None),
            ("serving_f32", FLASH_MAIN, torch.float32, "f32tc", None),
            ("gemma2_f32", FLASH_GEMMA2, torch.float32, "f32tc", None),
            ("serving_f32_simt", FLASH_MAIN, torch.float32, "simt",
             "simt")):
        # as attention hands them over: (B, H, L, D) views of (B, L, H, D)
        q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in _qkv(torch, gen, dev, dtype,
                                 qk_std=math.sqrt(2.0), **shp))
        *e, route = _flash_case(torch, q, k, v, shp["causal"], shp["window"],
                                shp["softcap"], named)
        if route != want:
            raise AssertionError(f"the {name} shape ran the {route} route")
        shapes[name] = {"shape": shp, "dtype": str(dtype).split(".")[-1],
                        "o": e[0], "lse": e[1], "route": route}
        routes[route] += 1
        expected[want] += 1
        cases += 1
        del q, k, v
    torch.cuda.empty_cache()
    if routes != expected:
        raise AssertionError(f"cases by route {routes}, expected {expected}")
    return {"cases": cases, "cases_by_route": routes,
            "tolerance": {"o": FLASH_TOL, "lse": LSE_TOL,
                          "rule": "|kernel - plain| <= atol + rtol*|plain|"},
            "max_abs_err_by_group": groups, "main_shapes": shapes,
            "max_abs_err": {"flash_attention": shapes["serving"]["o"],
                            "flash_attention_d256": shapes["gemma2"]["o"],
                            "flash_attention_f32tc":
                                shapes["serving_f32"]["o"],
                            "flash_attention_simt":
                                shapes["serving_f32_simt"]["o"]}}


# -- phase 7 -------------------------------------------------------------------

def serve(torch, dev, K, arch=SERVE_ARCH, init=None) -> dict:
    """``ServeEngine.generate`` on the full ``arch`` with the flash route
    on, weights from ``init`` (by default ``serving_params``); the launch
    counts of that one call; then the flash route's prefill logits against
    the q-chunked route's on the same weights and prompts, in the model's
    bf16 compute and in f32, each held to LOGIT_GAP, each flash prefill's
    launches read on their own: one per layer on the kernel of the route
    its dtype takes (``flash_kernel``), none on any other."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine, cache_bytes
    cfg = dataclasses.replace(get_config(arch), flash=True)
    if PROMPT_LEN % cfg.flash_block:
        raise ValueError("the prompts must take the flash route")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = (init or serving_params)(model, torch.Generator(device=dev)
                                      .manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_len = PROMPT_LEN + NEW_TOKENS
    engine = ServeEngine(model, params, max_len=max_len)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (SERVE_BATCH, PROMPT_LEN))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out, stats = engine.generate(prompts, NEW_TOKENS)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if out.shape != (SERVE_BATCH, NEW_TOKENS) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"generated tokens out of range: {out.shape}, "
                             f"[{out.min()}, {out.max()}]")
    _, again = engine.generate(prompts, NEW_TOKENS)

    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    routes = {}
    for dtype in (torch.bfloat16, torch.float32):
        with compute_dtype(dtype), torch.inference_mode():
            K.reset_launch_counts()
            flash_logits, _ = model.prefill(params, batch)
            flash_launches = K.launch_counts()
            base_logits, _ = LM(dataclasses.replace(cfg, flash=False)
                                ).prefill(params, batch)
        for lg in (flash_logits, base_logits):
            if not torch.isfinite(lg).all():
                raise AssertionError("non-finite prefill logits")
        # bf16 compute runs the sm90 route, f32 the 3xTF32 kernel
        route = "sm90" if dtype == torch.bfloat16 else "f32tc"
        kernel = flash_kernel("fwd", route, cfg.head_dim)
        ran = {n: flash_launches[n] for n in FLASH_KERNELS}
        want = {n: cfg.n_layers * (n == kernel) for n in FLASH_KERNELS}
        if ran != want:
            raise AssertionError(f"{dtype} flash prefill: launches {ran}, "
                                 f"expected {want} (one {kernel} launch per "
                                 f"layer)")
        routes[str(dtype).split(".")[-1]] = {
            "logit_gap": float((flash_logits - base_logits).abs().max()
                               / base_logits.abs().max()),
            "same_greedy_first_token_share": float(
                (flash_logits.argmax(-1) == base_logits.argmax(-1))
                .float().mean()),
            "flash_launches": flash_launches}
    for name, r in routes.items():
        if r["logit_gap"] >= LOGIT_GAP:
            raise AssertionError(
                f"{name}: flash route's prefill logits differ from the "
                f"q-chunked route's by {r['logit_gap']} of their max")
    profile = profile_serving(torch, model, params, batch)
    del params, engine, flash_logits, base_logits
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers,
            "head_dim": cfg.head_dim, "flash": True,
            "batch": SERVE_BATCH, "prompt_len": PROMPT_LEN,
            "new_tokens": NEW_TOKENS, "init_seconds": init_s,
            "prefill_seconds": stats.prefill_seconds,
            "decode_seconds": stats.decode_seconds,
            "decode_tok_per_s": stats.decode_tps,
            "second_call": {"prefill_seconds": again.prefill_seconds,
                            "decode_tok_per_s": again.decode_tps},
            "cache_bytes": cache_bytes(model, SERVE_BATCH, max_len),
            "peak_memory_bytes": peak,
            "flash_vs_q_chunked": routes, "profile": profile,
            "first_tokens": out[:, :4].tolist(), "launches": launches}


def serving_params(model, generator) -> dict:
    """Random weights for the serving run: the reference's init laws
    (``LM.init``), then q, k, v and the output projection rescaled to
    fan-in over the axes their products contract (1/sqrt(d_model) and
    1/sqrt(Hq*D)).  The reference's ``materialize`` takes fan-in from a
    tensor's second-last axis, which for these (d_model, heads, head_dim)
    tensors is the head count: qwen2.5-3b's scores then have a std of
    about 360, every attention row is an argmax, and a rounding
    difference anywhere flips rows, so the flash and q-chunked routes
    disagree by O(1) at the logits even in f32.  Rescaled, the scores
    have a std of about 1, as a trained model's are of order 1-10."""
    cfg = model.cfg
    params = model.init(generator)
    for a in _attn_params(params["segments"]):
        a["wq"].mul_(math.sqrt(cfg.n_heads / cfg.d_model))
        a["wk"].mul_(math.sqrt(cfg.n_kv / cfg.d_model))
        a["wv"].mul_(math.sqrt(cfg.n_kv / cfg.d_model))
        a["wo"].mul_(1.0 / math.sqrt(cfg.n_heads))
    return params


def _attn_params(tree) -> list:
    """Every attention's parameters in ``tree``: a segment's ``attn``, or
    its ``local`` and ``global`` layers' (gemma2-2b's ``pair_lg``)."""
    if isinstance(tree, dict):
        return [tree] if "wq" in tree else \
            [a for v in tree.values() for a in _attn_params(v)]
    if isinstance(tree, list):
        return [a for v in tree for a in _attn_params(v)]
    return []


@contextlib.contextmanager
def compute_dtype(dtype):
    """The model stack's compute dtype (bf16 in the reference) for the
    duration of the block."""
    from repro_torch.models import layers
    saved, layers._COMPUTE = layers._COMPUTE, dtype
    try:
        yield
    finally:
        layers._COMPUTE = saved


def profile_serving(torch, model, params, batch) -> dict:
    """Device time by kernel of one prefill and of 4 decode steps
    (``torch.profiler``), beside their host-clock time under the profiler:
    the device's busy share, the kernel count, the kernels that take the
    most of it, and the flash forward kernels' time and launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}

    def run(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device entries only: a CPU op's device time repeats its kernels'
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        device_us = sum(r[1] for r in rows)
        top = sorted(rows, key=lambda r: -r[1])[:8]
        flash = [r for r in rows if "flash_fwd" in r[0]]
        out[name] = {"wall_ms": wall * 1e3,
                     "device_ms": device_us / 1e3 if rows else None,
                     "busy_share": device_us / 1e3 / (wall * 1e3)
                     if rows else None,
                     "kernels": sum(r[2] for r in rows),
                     "flash_fwd_ms": sum(r[1] for r in flash) / 1e3,
                     "flash_fwd_calls": {k[:60]: c for k, _, c in flash},
                     "top": [{"name": k[:60], "ms": t / 1e3, "calls": c}
                             for k, t, c in top]}

    with torch.inference_mode():
        _, cache = model.prefill(params, batch)      # warm
        run("prefill", lambda: model.prefill(params, batch,
                                             cache_len=PROMPT_LEN + 4))
        _, cache = model.prefill(params, batch, cache_len=PROMPT_LEN + 4)
        tok = batch["tokens"][:, -1:]

        def decode4():
            for i in range(4):
                model.decode_step(params, cache, tok, PROMPT_LEN + i)

        run("decode_4_steps", decode4)
    return out


# -- phase 8 -------------------------------------------------------------------

def live_pairs(Lq: int, Lk: int, causal: bool, window) -> int:
    """(q, k) pairs the masks keep: the work the data needs."""
    qp = np.arange(Lq)
    lo = np.zeros(Lq, np.int64) if window is None else \
        np.maximum(qp - window + 1, 0)
    hi = np.minimum(qp + 1, Lk) if causal else np.full(Lq, Lk)
    return int(np.maximum(hi - lo, 0).sum())


def flash_timings(torch, dev) -> dict:
    """The forward's kernels at the serving and training shapes and at
    gemma2-2b's, bf16: the sm90 route (``ms``; gemma2-2b's runs its
    head_dim-256 kernel, also timed without the softcap,
    ``ms_no_softcap``, as SDPA has none) and the CUDA-core kernel on the
    same inputs (``simt_ms``, through the wrapper's module-private launcher
    that names the route), beside the bound, the plain version and SDPA
    (causal; gemma2-2b's window of 4096 masks nothing at L 2048).  Then
    f32 inputs at the same three shapes, the f32 prefill's and the f32
    training comparison's: the 3xTF32 kernel (``ms``, through the
    wrapper) beside the CUDA-core kernel on the same inputs
    (``simt_ms``), the 3xTF32 bound (``bound_ms``: three TF32 products a
    useful flop at the TF32 peak) and the CUDA-core one
    (``simt_bound_ms``: f32 at 67 TFLOP/s), the plain version and SDPA in
    f32."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    FA = sys.modules["repro_torch.kernels.flash_attention"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def timed(shp, dtype, peak, kernels, simt_peak=None) -> dict:
        q, k, v = _qkv(torch, gen, dev, dtype, **shp)
        B, Hq, L, D = q.shape
        scale = 1.0 / D ** 0.5
        masks = (shp["causal"], shp["window"], shp["softcap"])
        flops = 4 * B * Hq * D * live_pairs(L, L, shp["causal"],
                                            shp["window"])
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, q)) \
            + B * Hq * L * 4                # O like q, and the f32 LSE
        res = {"shape": {**shp, "dtype": str(dtype).split(".")[-1]},
               "flops": flops, "bytes": nbytes,
               **{key: time_ms(lambda fn=fn: fn(q, k, v, scale, *masks))
                  for key, fn in kernels.items()},
               "plain_ms": time_ms(lambda: flash_attention_ref(
                   q, k, v, scale, *masks)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, scale=scale, enable_gqa=True)),
               "bound_ms": max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
               "bound_by": "operations" if flops / peak >
               nbytes / HBM_BYTES_PER_S else "bytes"}
        for key in (*kernels, "plain_ms", "library_ms"):
            res[f"{key}_quartiles"] = [res[key]["p25"], res[key]["p75"]]
            res[key] = res[key]["median"]
        for key in kernels:
            res[key.replace("ms", "tflops")] = flops / res[key] / 1e9
        if simt_peak is not None:
            res["simt_bound_ms"] = flops / simt_peak * 1e3
        return res

    def simt(q, k, v, scale, causal, window, softcap):
        return FA._launch(q, k, v, scale, causal, window, softcap,
                          route="simt")

    def no_softcap(q, k, v, scale, causal, window, _):
        return flash_attention(q, k, v, scale, causal, window)

    both = {"ms": flash_attention, "simt_ms": simt}
    out = {"serving": timed(FLASH_MAIN, torch.bfloat16, BF16_FLOPS, both),
           "training": timed(FLASH_TRAIN, torch.bfloat16, BF16_FLOPS, both),
           "gemma2": timed(FLASH_GEMMA2, torch.bfloat16, BF16_FLOPS,
                           {**both, "ms_no_softcap": no_softcap}),
           "f32_serving": timed(FLASH_MAIN, torch.float32, TF32X3_FLOPS,
                                both, F32_FLOPS),
           "f32_training": timed(FLASH_TRAIN, torch.float32, TF32X3_FLOPS,
                                 both, F32_FLOPS),
           "f32_gemma2": timed(FLASH_GEMMA2, torch.float32, TF32X3_FLOPS,
                               {**both, "ms_no_softcap": no_softcap},
                               F32_FLOPS)}
    torch.cuda.empty_cache()
    return out


# -- phase 10 ------------------------------------------------------------------

def _bwd_kernel(torch, kind, args, route=None) -> tuple:
    """One backward kernel's outputs, ``(dq,)`` for ``kind`` "dq" or
    ``(dk, dv)`` for "dkv": through its wrapper, which takes
    ``_route``'s route, or on ``route`` named through the
    module-private launcher (a comparison of the two routes)."""
    from repro_torch.kernels import flash_attention_dkv, flash_attention_dq
    if route is None:
        return (flash_attention_dq(*args),) if kind == "dq" else \
            flash_attention_dkv(*args)
    FA = sys.modules["repro_torch.kernels.flash_attention"]
    q, k = args[0], args[1]
    if kind == "dq":
        outs = (torch.empty(q.shape, dtype=q.dtype, device=q.device),)
    else:
        outs = tuple(torch.empty((q.shape[0], q.shape[1], k.shape[2],
                                  q.shape[3]), dtype=torch.float32,
                                 device=q.device) for _ in range(2))
    FA._launch_bwd(kind, outs, *args, route=route)
    return outs


def _bwd_case(torch, q, k, v, causal, window, softcap, gen,
              route=None) -> tuple:
    """The dQ and dK/dV kernels against their plain versions on the same
    q, k, v, dO and the plain forward's O and LSE: (max |d dQ|,
    max |d dK|, max |d dV|, the route that ran), raising beyond the
    tolerances and unless exactly one launch each was counted on the dq
    and dkv kernels of ``route`` (by default the one ``_route``
    picks) at this head dim (``flash_kernel``), and none on any other."""
    import repro_torch.kernels as K
    from repro_torch.kernels.ref import (flash_attention_dkv_ref,
                                         flash_attention_dq_ref,
                                         flash_attention_ref)
    FA = sys.modules["repro_torch.kernels.flash_attention"]
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = flash_attention_ref(q, k, v, scale, causal, window, softcap)
    do = (0.5 * torch.randn(q.shape, generator=gen, device=q.device)
          ).to(q.dtype)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal, window, softcap)
    want = route or FA._route(q.dtype, q.shape[-1], "bwd")
    before = K.launch_counts()
    dq, dk, dv = (*_bwd_kernel(torch, "dq", args, route),
                  *_bwd_kernel(torch, "dkv", args, route))
    ran = flash_deltas(before, K.launch_counts())
    kernels = {flash_kernel(kind, want, q.shape[-1]) for kind in ("dq", "dkv")}
    if ran != {n: int(n in kernels) for n in FLASH_KERNELS}:
        raise AssertionError(f"{q.dtype} D {q.shape[-1]}: expected one "
                             f"launch each of {sorted(kernels)}, counted "
                             f"{ran}")
    rdq, (rdk, rdv) = flash_attention_dq_ref(*args), \
        flash_attention_dkv_ref(*args)
    torch.cuda.synchronize()
    rtol, atol = BWD_TOL[str(q.dtype).split(".")[-1]]
    return (close_err(dq.float(), rdq.float(), rtol, atol),
            close_err(dk, rdk, *BWD_TOL["float32"]),
            close_err(dv, rdv, *BWD_TOL["float32"]), want)


def check_flash_bwd(torch, dev) -> dict:
    """The backward kernels against their plain versions, each case
    counted as one dq and one dkv launch on the route its dtype and head
    dim pick; each route's total against the cases the sweep sends it."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    masks = {"causal": (True, None, None), "non_causal": (False, None, None),
             "window": (True, 48, None), "softcap": (True, None, 30.0),
             "window_softcap": (False, 48, 30.0)}
    groups: dict = {}
    routes = dict.fromkeys(FLASH_ROUTES, 0)
    expected = dict.fromkeys(FLASH_ROUTES, 0)
    cases = 0
    # the forward's sweep: ragged lengths, Lq != Lk, zero-padded head dims
    for dtype in (torch.float32, torch.bfloat16):
        for name, (causal, window, softcap) in masks.items():
            worst = [0.0, 0.0, 0.0]
            for g in (1, 2, 4, 8):
                for D in (16, 24, 32, 48, 80, 128, 200, 256):
                    q, k, v = _qkv(torch, gen, dev, dtype, B=2, Hq=2 * g,
                                   Hkv=2, L=200, D=D,
                                   Lk=136 if g == 2 else None,
                                   qk_std=math.sqrt(2.0))
                    *e, route = _bwd_case(torch, q, k, v, causal, window,
                                          softcap, gen)
                    worst = [max(a, b) for a, b in zip(worst, e)]
                    routes[route] += 1
                    expected["sm90" if dtype == torch.bfloat16
                             else "f32tc"] += 1
                    cases += 1
            groups[f"{name}/{str(dtype).split('.')[-1]}"] = dict(
                zip(("dq", "dk", "dv"), worst))
    # the training shape and gemma2-2b's full length, as attention hands
    # them over: (B, H, L, D) views, bf16 and f32 on the routes the
    # wrappers take (sm90, its head_dim-256 kernels at gemma2-2b's; f32tc),
    # and the training shape's f32 inputs once more on the CUDA-core route,
    # named
    train, gemma2 = {}, {}
    for shp, out, runs in ((FLASH_TRAIN, train,
                            ((torch.bfloat16, None), (torch.float32, None),
                             (torch.float32, "simt"))),
                           (FLASH_GEMMA2, gemma2,
                            ((torch.bfloat16, None), (torch.float32, None)))):
        for dtype, route in runs:
            q, k, v = (x.transpose(1, 2).contiguous().transpose(1, 2)
                       for x in _qkv(torch, gen, dev, dtype,
                                     qk_std=math.sqrt(2.0), **shp))
            *e, ran = _bwd_case(torch, q, k, v, shp["causal"], shp["window"],
                                shp["softcap"], gen, route)
            out[ran] = {"shape": {**shp, "dtype": str(dtype).split(".")[-1]},
                        **dict(zip(("dq", "dk", "dv"), e))}
            routes[ran] += 1
            expected[route or ("sm90" if dtype == torch.bfloat16
                               else "f32tc")] += 1
            cases += 1
            del q, k, v
    if routes != expected:
        raise AssertionError(f"cases by route {routes}, expected {expected}")
    # the autograd.Function (kernels) against autograd through the plain
    # forward, f32, every mask
    fn_err = {}
    for name, (causal, window, softcap) in masks.items():
        q, k, v = (x.requires_grad_() for x in _qkv(
            torch, gen, dev, torch.float32, B=2, Hq=8, Hkv=2, L=200, D=64,
            qk_std=math.sqrt(2.0)))
        do = torch.randn(q.shape, generator=gen, device=dev)
        got = torch.autograd.grad(flash_attention(q, k, v, None, causal,
                                                  window, softcap), (q, k, v),
                                  do)
        want = torch.autograd.grad(flash_attention_ref(
            q, k, v, None, causal, window, softcap)[0], (q, k, v), do)
        fn_err[name] = max(close_err(a, b, *BWD_TOL["float32"])
                           for a, b in zip(got, want))
        cases += 1
    torch.cuda.empty_cache()
    return {"cases": cases, "cases_by_route": routes,
            "tolerance": {"dq": BWD_TOL, "dk_dv": BWD_TOL["float32"],
                          "rule": "|kernel - plain| <= atol + rtol*|plain|"},
            "max_abs_err_by_group": groups, "training_shape": train,
            "gemma2_shape": gemma2,
            "autograd_vs_plain_forward_f32": fn_err,
            "max_abs_err": {
                f"flash_attention_{kind}{suffix}": (
                    case["dq"] if kind == "dq" else
                    max(case["dk"], case["dv"]))
                for case, suffix in ((train["sm90"], ""),
                                     (gemma2["sm90"], "_d256"),
                                     (train["f32tc"], "_f32tc"),
                                     (train["simt"], "_simt"))
                for kind in ("dq", "dkv")}}


# -- phase 11 ------------------------------------------------------------------

def train(torch, dev, K, arch=SERVE_ARCH, hand_over=None) -> dict:
    """The training path at ``arch``'s full width: the flash route's
    gradients against the q-chunked route's, then ``Trainer.run`` with the
    launch counts of that one call, then a profile of one more step.  With
    a ``hand_over`` dict, the trained params and AdamW state go into it
    (the checkpoint phase saves them) instead of being freed."""
    import dataclasses
    import itertools
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticTokens
    from repro_torch.models import LM
    from repro_torch.train import OptimizerConfig, Trainer, adamw_init
    cfg = dataclasses.replace(get_config(arch), flash=True)
    if TRAIN_SEQ % cfg.flash_block or cfg.remat != "dots":
        raise ValueError("the training run must take the flash route under "
                         "remat='dots'")
    model = LM(cfg)
    t0 = time.perf_counter()
    params = training_params(model, torch.Generator(device=dev)
                             .manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host_batch = next(SyntheticTokens(PipelineConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab,
        seed=SEED)))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host_batch.items()}

    routes = compare_train_routes(torch, model, params, batch)

    trainer = Trainer(model, OptimizerConfig(**TRAIN_OPT),
                      itertools.repeat(host_batch))
    opt = adamw_init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    params, opt, hist = trainer.run(params, opt, TRAIN_STEPS, log_every=0)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for _, m in hist]
    norms = [m["grad_norm"] for _, m in hist]
    per_step = {k: n / TRAIN_STEPS for k, n in launches.items()}
    steps = [m["step_seconds"] for _, m in hist]
    steady = statistics.median(steps[1:])
    profile = profile_train_step(torch, trainer, params, opt, K)
    if hand_over is not None:
        hand_over.update(params=params, opt=opt)
    del params, opt, trainer
    torch.cuda.empty_cache()
    return {"arch": arch, "layers": cfg.n_layers,
            "head_dim": cfg.head_dim, "flash": True,
            "remat": cfg.remat, "global_batch": TRAIN_BATCH,
            "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
            "optimizer": TRAIN_OPT,
            "params": model.num_params(), "init_seconds": init_s,
            "flash_vs_q_chunked": routes, "losses": losses,
            "grad_norms": norms, "lrs": [m["lr"] for _, m in hist],
            "step_seconds": steps, "steady_step_seconds": steady,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
            "peak_memory_bytes": peak, "launches": launches,
            "launches_per_step": per_step, "profile": profile}


def check_training(trained: dict) -> None:
    """A training run's gates, for its arch's layer count and head dim:
    f32 gradients of the flash route within GRAD_GAP_F32 of the q-chunked
    route's per leaf and bf16 losses within LOSS_GAP_BF16; the bf16 route
    comparison's backward on the sm90 kernels (``flash_kernel``: the
    head_dim-256 ones above 128) and the f32 one's on the 3xTF32 kernels,
    one dq and one dkv a layer (none on the CUDA-core ones), after the
    3xTF32 forward as many times as the bf16 one's sm90 forward; every
    loss and grad norm finite
    and positive; the last loss below the first; per step one launch a
    layer of the sm90 dq and dkv kernels for this head dim, two of its
    sm90 forward, none on any other flash kernel (the CUDA-core ones
    included)."""
    routes = trained["flash_vs_q_chunked"]
    n, D = trained["layers"], trained["head_dim"]
    bwd = [name for name in FLASH_KERNELS if "_dq" in name or "_dkv" in name]
    for dtype, route in (("bfloat16", "sm90"), ("float32", "f32tc")):
        got = routes[dtype]["flash_launches"]
        ran = {flash_kernel(kind, route, D) for kind in ("dq", "dkv")}
        want = {name: n * (name in ran) for name in bwd}
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"the {dtype} route comparison's backward "
                                 f"launched {got}, expected {want}")
    fwd = [name for name in FLASH_KERNELS if name not in bwd]
    got = routes["float32"]["flash_launches"]
    want = {name: 0 for name in fwd}
    want["flash_attention_f32tc"] = \
        routes["bfloat16"]["flash_launches"][flash_kernel("fwd", "sm90", D)]
    if not want["flash_attention_f32tc"] or \
            {k: got[k] for k in want} != want:
        raise AssertionError(f"the float32 route comparison's forward "
                             f"launched {got}, expected {want}")
    if routes["float32"]["over_limit"]:
        raise AssertionError(f"f32 gradients of the flash route differ from "
                             f"the q-chunked route's: "
                             f"{routes['float32']['over_limit']}")
    if not routes["bfloat16"]["loss_gap"] < LOSS_GAP_BF16:
        raise AssertionError(f"bf16 losses differ: {routes['bfloat16']}")
    losses, norms = trained["losses"], trained["grad_norms"]
    if not all(math.isfinite(x) and x > 0 for x in losses + norms):
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    per_step = trained["launches_per_step"]
    want = dict.fromkeys(FLASH_KERNELS, 0)
    want[flash_kernel("fwd", "sm90", D)] = 2 * n
    want[flash_kernel("dq", "sm90", D)] = n
    want[flash_kernel("dkv", "sm90", D)] = n
    if {k: per_step[k] for k in want} != want:
        raise AssertionError(f"launches per step {per_step}, not {want}: "
                             f"one sm90 dq and one sm90 dkv per layer and "
                             f"two sm90 forwards (the dots recompute runs "
                             f"it again), none on any other flash kernel")


def check_gemma2_serving(served: dict) -> None:
    """The gemma2-2b serving run's gates beyond ``serve``'s own: its one
    bf16 prefill launched the sm90 forward once per layer, every launch on
    the head_dim-256 kernel, and the f32 forwards never."""
    n, got = served["layers"], served["launches"]
    if not (got["flash_attention_d256"] == n and got["flash_attention"] == 0
            and got["flash_attention_simt"] == 0
            and got["flash_attention_f32tc"] == 0):
        raise AssertionError(f"gemma2-2b serving launched {got}, not one "
                             f"head_dim-256 sm90 forward per layer ({n})")


def training_params(model, generator) -> dict:
    """Random weights for the training run: ``serving_params``, then the
    tied embedding rescaled from the reference's std 1 to
    1/sqrt(d_model).  At std 1 the logits h.E have a std of sqrt(d_model)
    = 45, the first loss is 331 against ln(vocab) = 11.9, and AdamW's
    steps of about lr per weight overshoot: the loss went 331, 184, 259,
    575, 518, 438 over 6 steps at lr 3e-4 (an H100, PERF.md).  At
    1/sqrt(d_model) the logits have a std of about 1, as at a real
    model's initialization (std 0.02).  gemma2-2b's serving run takes
    them too: it multiplies the tied embedding by sqrt(d_model), and at
    std 1 its final logits (std about 48) saturate the final softcap of
    30, where greedy near-ties make the route comparison meaningless."""
    params = serving_params(model, generator)
    params["embed"].mul_(1.0 / math.sqrt(model.cfg.d_model))
    return params


def compare_train_routes(torch, model, params, batch) -> dict:
    """Loss and gradients of the flash and q-chunked routes on the same
    weights and batch, in f32 and in bf16 compute.  The flash route's
    gradients wait on the host while the q-chunked route runs.  A gap is
    max |d| / max |q-chunked| over one leaf, or over one layer's slice of
    a layer-stacked leaf (``.../wq[35]``), so a layer whose gradients are
    small is held to its own scale; ``check_training`` gates every gap.
    Reported: the largest gaps, those of the embedding, the final norm and
    the first and last layers, the flash route's kernel launches, and for
    f32 the device time of the flash route's loss and gradients by kernel
    family (``torch.profiler``)."""
    import dataclasses
    import repro_torch.kernels as K
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import LM
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.trainer import value_and_grad
    base = LM(dataclasses.replace(model.cfg, flash=False))
    counts = [c for _, c in model.cfg.program]
    names = _leaf_names(params)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        f32 = dtype == torch.float32
        with compute_dtype(dtype):
            before = K.launch_counts()
            with (profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) if f32
                  else contextlib.nullcontext()) as prof:
                fl, _, fg = value_and_grad(model, params, batch)
                torch.cuda.synchronize()
            after = K.launch_counts()
            fg = [g.cpu() for g in tree_leaves(fg)]
            bl, _, bg = value_and_grad(base, params, batch)
        gaps = {}
        for name, a, b in zip(names, fg, tree_leaves(bg)):
            if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
                raise AssertionError(f"non-finite gradient of {name}")
            parts = name.split("/")
            pieces = ([(f"{name}[{i}]", a[i], b[i]) for i in range(len(b))]
                      if parts[0] == "segments" and counts[int(parts[1])] > 1
                      else [(name, a, b)])
            for key, x, y in pieces:
                d = (x.to(y.device) - y).abs().max()
                gaps[key] = float(d / y.abs().max().clamp_min(1e-30))
        del fg, bg
        torch.cuda.empty_cache()
        if f32:
            gaps_f32 = gaps
            rows = [(e.key, e.self_device_time_total)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            step_profile = {
                "device_ms": sum(t for _, t in rows) / 1e3,
                **{f"{tag}_ms": sum(t for k, t in rows if tag in k) / 1e3
                   for tag in ("flash_fwd", "flash_dq", "flash_dkv")}}
        last = counts[0] - 1
        shown = {k: v for k, v in gaps.items()
                 if "[" not in k or k.endswith(("[0]", f"[{last}]"))}
        out[str(dtype).split(".")[-1]] = {
            "loss_flash": float(fl), "loss_q_chunked": float(bl),
            "loss_gap": abs(float(fl) - float(bl)) / abs(float(bl)),
            "grad_gap_max": max(gaps.values()), "compared": len(gaps),
            "flash_launches": {k: after[k] - before[k] for k in after
                               if k.startswith("flash_attention")},
            "largest": dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:5]),
            "first_last_layers": shown}
    out["float32"]["over_limit"] = {
        k: v for k, v in gaps_f32.items() if not v < GRAD_GAP_F32}
    out["float32"]["profile"] = step_profile
    return out


def _leaf_names(tree, prefix="") -> list:
    """Path names of a tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{prefix}/{i}")]
    return [prefix.lstrip("/")]


def profile_train_step(torch, trainer, params, opt, K) -> dict:
    """Device time by kernel of one training step (``torch.profiler``),
    beside its host-clock time under the profiler: the busy share, the
    top kernels, the flash kernels' shares, and that step's launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(params, opt, 1, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = K.launch_counts()
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_us = sum(r[1] for r in rows)

    def share(tag):
        return sum(r[1] for r in rows if tag in r[0]) / device_us \
            if device_us else None

    top = sorted(rows, key=lambda r: -r[1])[:10]
    # each kernel's share of the step's device time, by its own name
    kernels = ("flash_fwd_sm90", "flash_fwd_sm90_d256", "flash_fwd_f32tc",
               "flash_fwd",
               "flash_dq_sm90", "flash_dq_sm90_d256", "flash_dq_f32tc",
               "flash_dq",
               "flash_dkv_sm90", "flash_dkv_sm90_d256", "flash_dkv_f32tc",
               "flash_dkv")
    return {"wall_ms": wall * 1e3,
            "device_ms": device_us / 1e3 if rows else None,
            "busy_share": device_us / 1e3 / (wall * 1e3) if rows else None,
            "kernels": sum(r[2] for r in rows),
            **{f"{k}_share": share(f"{k}_kernel") for k in kernels},
            "flash_fwd_ms": sum(r[1] for r in rows
                                if "flash_fwd" in r[0]) / 1e3,
            "flash_bwd_ms": sum(r[1] for r in rows if "flash_dq" in r[0]
                                or "flash_dkv" in r[0]) / 1e3,
            "launches": launches,
            "top": [{"name": k[:60], "ms": t / 1e3, "calls": c}
                    for k, t, c in top]}


# -- phase 12 ------------------------------------------------------------------

def bwd_timings(torch, dev) -> dict:
    """The backward kernels' times.  ``training``: at ``FLASH_TRAIN`` in
    bf16, each sm90 kernel (``ms``) beside the CUDA-core kernel on the same
    inputs (``simt_ms``, through the wrapper's module-private launcher that
    names the route), the bound, the plain version and the backward of one
    ``scaled_dot_product_attention`` (forward + backward minus forward,
    computing dQ, dK and dV together; device time from the profiler, as
    the backward's host work outlasts its kernels), with TFLOP/s of useful
    work.  ``gemma2``: the same at gemma2-2b's bf16 head_dim-256 shape
    (``FLASH_GEMMA2``) on the sm90 route's head_dim-256 kernels (SDPA
    causal without the softcap, which SDPA lacks; the window of 4096 masks
    nothing at L 2048); phase 8 times its forward.  ``training_f32`` and
    ``gemma2_f32``: the same two shapes on f32 inputs, those of the f32
    route comparisons: the 3xTF32 kernels (``ms``) beside the CUDA-core
    ones on the same inputs (``simt_ms``), the 3xTF32 bound (``bound_ms``:
    three TF32 products a useful flop at the TF32 peak) and the CUDA-core
    one (``simt_bound_ms``: f32 at 67 TFLOP/s), the plain versions and
    SDPA's backward in f32."""
    import torch.nn.functional as F
    from repro_torch.kernels import (flash_attention, flash_attention_dkv,
                                     flash_attention_dq)
    from repro_torch.kernels.ref import (flash_attention_dkv_ref,
                                         flash_attention_dq_ref)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def timed(res, name, flops, nbytes, peak, fns) -> None:
        r = {"flops": flops, "bytes": nbytes,
             **{key: time_ms(fn) for key, fn in fns.items()},
             "bound_ms": max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
             "bound_by": "operations" if flops / peak >
             nbytes / HBM_BYTES_PER_S else "bytes"}
        for key in fns:
            r[f"{key}_quartiles"] = [r[key]["p25"], r[key]["p75"]]
            r[key] = r[key]["median"]
            if key != "plain_ms":
                r[key.replace("ms", "tflops")] = flops / r[key] / 1e9
        res[name] = r

    def shape(shp, dtype, peak, suffix) -> dict:
        """Times at ``shp``, named ``flash_attention_{dq,dkv}{suffix}``."""
        causal, window, softcap = shp["causal"], shp["window"], shp["softcap"]
        q, k, v = _qkv(torch, gen, dev, dtype, **shp)
        B, Hq, L, D = q.shape
        scale = 1.0 / D ** 0.5
        o, lse = flash_attention(q, k, v, scale, causal, window, softcap,
                                 return_lse=True)
        do = (0.5 * torch.randn(q.shape, generator=gen, device=dev)
              ).to(dtype)
        delta = (do.float() * o.float()).sum(-1)
        args = (q, k, v, do, lse, delta, scale, causal, window, softcap)
        pairs = B * Hq * live_pairs(L, L, causal, window)
        size = q.element_size()
        ins = sum(x.numel() * x.element_size()
                  for x in (q, k, v, do, lse, delta))
        per_head = B * Hq * k.shape[2] * D * 4      # one f32 dK or dV
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qg, kg, vg, is_causal=True, scale=scale, enable_gqa=True)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qg, kg, vg), do)

        with torch.no_grad():
            fwd = device_ms(sdpa)
        library = device_ms(sdpa_fwd_bwd) - fwd
        res = {"shape": {**shp, "dtype": str(dtype).split(".")[-1]},
               "library_fwd_ms": fwd, "library_bwd_ms": library}
        for kind, kernel, plain, flops, nbytes in (
                ("dq", flash_attention_dq, flash_attention_dq_ref,
                 6 * D * pairs, ins + q.numel() * size),
                ("dkv", flash_attention_dkv, flash_attention_dkv_ref,
                 8 * D * pairs, ins + 2 * per_head)):
            def simt(kind=kind):
                return _bwd_kernel(torch, kind, args, "simt")
            fns = {"ms": lambda kernel=kernel: kernel(*args), "simt_ms": simt,
                   "plain_ms": lambda plain=plain: plain(*args)}
            name = f"flash_attention_{kind}{suffix}"
            timed(res, name, flops, nbytes, peak, fns)
            res[name]["library_ms"] = library
            if dtype == torch.float32:
                res[name]["simt_bound_ms"] = flops / F32_FLOPS * 1e3
        torch.cuda.empty_cache()
        return res

    return {"training": shape(FLASH_TRAIN, torch.bfloat16, BF16_FLOPS, ""),
            "training_f32": shape(FLASH_TRAIN, torch.float32, TF32X3_FLOPS,
                                  "_f32tc"),
            "gemma2": shape(FLASH_GEMMA2, torch.bfloat16, BF16_FLOPS,
                            "_d256"),
            "gemma2_f32": shape(FLASH_GEMMA2, torch.float32, TF32X3_FLOPS,
                                "_f32tc")}


# -- driver --------------------------------------------------------------------

# -- phase 15 ------------------------------------------------------------------

#: the checkpoint phase's decomposition: 2 simulated hosts of 4 devices (the
#: manager's devices_per_host), each leaf split 8 ways on its first axis
#: that 8 divides (replicated where none does); the elastic restore splits
#: CKPT_ELASTIC 4 ways on their last other axis that 4 divides, and the
#: relayout check saves the embedding under ``reorganized`` (8, 1)
CKPT_MESH, CKPT_AXES = (2, 4), ("host", "device")
CKPT_ELASTIC = ("params/embed", "params/segments/0/mlp/w_up")
CKPT_TARGETS = 4
CKPT_REORG = (8, 1)
COPY_KERNELS = ("pack_rows", "chunked_to_rowmajor", "rowmajor_to_chunked")


def _split_axis(shape, ways, skip=None, last=False):
    """The first (or last) axis of ``shape`` other than ``skip`` that
    ``ways`` divides, or None."""
    axes = [d for d, n in enumerate(shape) if d != skip and n % ways == 0]
    return (axes[-1] if last else axes[0]) if axes else None


def checkpoint(torch, dev, K, state: dict) -> dict:
    """The checkpoint path at full width on phase 11's trained tree (its
    params and AdamW state, popped from ``state``): ``save`` under
    ``merged_process`` from ``MeshSharding``s, the whole restore onto the
    card, an elastic restore of two leaves onto another axis, and the
    embedding alone under ``reorganized`` through the relayout kernels.
    Each step's launch counts are reset just before it and read just
    after; every check raises."""
    from repro_torch.checkpoint import (CheckpointManager, MeshSharding,
                                        blocks_from_sharding, flatten_pytree,
                                        reshard_cost_report, unflatten_like)
    from repro_torch.core import plan_layout, regular_decomposition
    tree = {"params": state.pop("params"), "opt_state": state.pop("opt")}
    flat = flatten_pytree(tree)
    ids = np.arange(math.prod(CKPT_MESH)).reshape(CKPT_MESH)
    axis = {n: _split_axis(t.shape, ids.size) for n, t in flat.items()
            if t.dim()}
    sh = {n: MeshSharding(ids, CKPT_AXES, () if d is None
                          else (None,) * d + (CKPT_AXES,))
          for n, d in axis.items()}
    shardings = unflatten_like(tree, {n: sh.get(n) for n in flat})
    root = ROOT / "build" / "chip_smoke" / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    launches = dict.fromkeys(COPY_KERNELS, 0)

    def counted(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: K.launch_counts()[k] for k in COPY_KERNELS}
        for k, n in got.items():
            launches[k] += n
        return out, seconds, got

    def stages(rs):
        return {"engine_read": rs.seconds, "lower": rs.lower_seconds,
                "h2d": rs.h2d_seconds, "linearize": rs.linearize_seconds}

    out = {"leaves": len(axis), "scalars": len(flat) - len(axis),
           "bytes": sum(t.numel() * t.element_size() for t in flat.values()),
           "hosts": CKPT_MESH[0], "devices_per_host": CKPT_MESH[1],
           "split_axes": {n: d for n, d in axis.items()
                          if n.startswith("params/")}}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out["disk_free_before"] = shutil.disk_usage(root).free
    need = out["bytes"] + flat["params/embed"].numel() * 4
    if out["disk_free_before"] < need:
        raise RuntimeError(f"{root} has {out['disk_free_before']} bytes "
                           f"free; the checkpoints take {need}")
    try:
        mgr = CheckpointManager(str(root / "merged"), keep=1,
                                devices_per_host=CKPT_MESH[1])
        step = TRAIN_STEPS + 1
        st, secs, ran = counted(lambda: mgr.save(step, tree,
                                                 shardings=shardings))
        out["disk_free_after_save"] = shutil.disk_usage(root).free
        fpp = sum(plan_layout("subfiled_fpp", blocks_from_sharding(
            tuple(flat[n].shape), sh[n], CKPT_MESH[1]),
            num_procs=CKPT_MESH[0]).num_chunks for n in axis)
        out["save"] = {
            "seconds": secs, "bytes": st.bytes, "chunks": st.num_chunks,
            "subfiled_fpp_chunks": fpp, "blocks": st.num_original_blocks,
            "stored_bytes": sum(p.stat().st_size for p in
                                Path(mgr.step_dir(step)).iterdir()),
            "stages": {"lower": st.lower_seconds,
                       "kernel": st.kernel_seconds, "d2h": st.d2h_seconds,
                       "engine_write": st.write_seconds,
                       "checksum_and_index": st.commit_seconds},
            "launches": ran,
            # the params' share, what phase 17b stages asynchronously
            "params_seconds": sum(v for n, v in st.per_var_seconds.items()
                                  if n.startswith("params/"))}
        if ran["pack_rows"] < len(axis):
            raise AssertionError(f"save launched pack_rows {ran['pack_rows']}"
                                 f" times for {len(axis)} leaves")

        (got, rs), secs, ran = counted(lambda: mgr.restore(step,
                                                           template=tree))
        gflat = flatten_pytree(got)
        bad = [n for n, t in flat.items()
               if gflat[n].device != t.device or gflat[n].dtype != t.dtype
               or gflat[n].shape != t.shape or not torch.equal(gflat[n], t)]
        if bad:
            raise AssertionError(f"whole restore differs: {bad}")
        out["restore"] = {"seconds": secs, "bytes_read": rs.bytes_read,
                          "chunks_touched": rs.chunks_touched,
                          "stages": stages(rs), "launches": ran,
                          "tolerance": "bit-exact: torch.equal every leaf"}
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        del got, gflat
        torch.cuda.empty_cache()

        targets, target_axis = {}, {}
        for n in CKPT_ELASTIC:
            d = target_axis[n] = _split_axis(flat[n].shape, CKPT_TARGETS,
                                             skip=axis[n], last=True)
            scheme = [1] * flat[n].dim()
            scheme[d] = CKPT_TARGETS
            targets[n] = regular_decomposition(tuple(flat[n].shape), scheme)
        (got, rs), secs, ran = counted(lambda: mgr.restore(
            step, target_blocks=targets))
        for n, blocks in targets.items():
            for b in blocks:
                if not torch.equal(got[n][b.block_id], flat[n][b.slices()]):
                    raise AssertionError(f"elastic restore of {n} differs "
                                         f"in {b}")
        # one launch a variable: the region route's pack_rows for the
        # targets, the whole route's pack_rows or, on an even 2-D chunk
        # grid, chunked_to_rowmajor for the rest
        if ran["pack_rows"] + ran["chunked_to_rowmajor"] != len(axis) or \
                ran["pack_rows"] < len(targets):
            raise AssertionError(f"elastic restore of {len(axis)} "
                                 f"variables launched {ran}")
        out["elastic"] = {
            "seconds": secs, "launches": ran,
            "vars": {n: {"shape": list(flat[n].shape),
                         "saved_axis": axis[n],
                         "target_axis": target_axis[n],
                         "stages": stages(rs.per_var[n]),
                         "bytes_read": rs.per_var[n].bytes_read,
                         "chunks_touched": rs.per_var[n].chunks_touched,
                         "report": reshard_cost_report(mgr.step_dir(step),
                                                       n, targets[n])}
                     for n in targets}}
        out["peak_memory_bytes"] = max(out["peak_memory_bytes"],
                                       torch.cuda.max_memory_allocated())
        del got
        torch.cuda.empty_cache()

        emb = flat["params/embed"]
        reorg = CheckpointManager(str(root / "reorganized"),
                                  strategy="reorganized",
                                  reorg_scheme=CKPT_REORG, keep=1,
                                  devices_per_host=CKPT_MESH[1])
        st, save_s, save_ran = counted(lambda: reorg.save(
            step, {"embed": emb}, shardings={"embed": sh["params/embed"]}))
        (got, rs), secs, ran = counted(lambda: reorg.restore(step))
        if save_ran["rowmajor_to_chunked"] < 1 or \
                ran["chunked_to_rowmajor"] < 1 or \
                not torch.equal(got["embed"], emb):
            raise AssertionError(f"reorganized embedding: save {save_ran}, "
                                 f"restore {ran}")
        out["reorganized"] = {"scheme": list(CKPT_REORG),
                              "chunks": st.num_chunks,
                              "save_seconds": save_s,
                              "save_launches": save_ran,
                              "restore_seconds": secs,
                              "restore_stages": stages(rs),
                              "restore_launches": ran}
        del got
        out["peak_memory_bytes"] = max(out["peak_memory_bytes"],
                                       torch.cuda.max_memory_allocated())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"the checkpoint path never launched {missing}")
    out["launches"] = launches
    return out


# -- phase 16 ------------------------------------------------------------------

#: the reorganization phase's 3-D cell: a WarpX-style component at the
#: paper's aspect, §5.2's 2048 x 4096 x 4096 f32 cut 64 ways in volume (2
#: GiB), in 64 x 64 x 128 boxes over the slice-1 ranks; reorganized out of
#: place to the default 4 x 4 x 4 scheme (64 chunks of 32 MiB), then in
#: place to 2 x 8 x 4; the Fig.-6 patterns read by 8 readers.  The 2-D cell
#: is slice 1's component reorganized to 8 x 8
REORG_FIELD = (512, 1024, 1024)
REORG_BOX = (64, 64, 128)
REORG_SCHEMES = ((4, 4, 4), (2, 8, 4))
REORG_2D = (8, 8)
PATTERN_READERS = 8
#: the 3-D component's access history after phase 16's pattern reads,
#: exported as phase 17a's cross-run prior
STAGING_PRIOR = ROOT / "build" / "chip_smoke" / "warpx_prior.json"


def _reorg_stages(rs: float, ws) -> dict:
    """``reorganize``'s stages: the gather's (engine read, lowering, copy
    to the card, the ``pack_rows`` launch), its copy back, the engine
    write, and the checksums and index."""
    g = ws.gather
    return {"gather": rs, "engine_read": g.seconds, "lower": g.lower_seconds,
            "h2d": g.h2d_seconds, "kernel": g.linearize_seconds,
            "d2h": ws.d2h_seconds, "engine_write": ws.write_seconds,
            "checksum_and_index": ws.total_seconds - ws.assemble_seconds
            - ws.write_seconds}


def reorg(torch, dev, K, blocks2d) -> dict:
    """Post-hoc reorganization on the card (paper §5): slice 1's component
    and a WarpX-style 3-D component, each written under
    ``merged_process`` and reorganized through ``reorganize`` (every new
    chunk gathered by one ``pack_rows`` launch a batch), read back whole
    and held to the source; the 3-D one also in place, and its six Fig.-6
    patterns read by ``Dataset.read`` and ``read_pattern`` under both
    layouts with ``engine="auto"``.  Each reorganize's and read-back's
    launch counts are reset just before it and read just after; every
    check raises.  The reads come from the page cache."""
    from repro_torch.core import (PATTERNS, AccessLog, pattern_region,
                                  plan_layout, plan_reorganization,
                                  simulate_load_balance, uniform_grid_blocks)
    from repro_torch.core.blocks import Block
    from repro_torch.io import Dataset, reorganize
    from repro_torch.io.device import GATHER_BATCH_BYTES, gather_batches
    work = ROOT / "build" / "chip_smoke" / "reorg"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches = dict.fromkeys(COPY_KERNELS, 0)

    def counted(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = {k: K.launch_counts()[k] for k in COPY_KERNELS}
        for k, n in got.items():
            launches[k] += n
        return out, seconds, got

    def batches(layout) -> int:
        return len(gather_batches(layout, 4))

    def read_back(d, var, field, want):
        ds = Dataset.open(str(d))
        whole = Block((0,) * field.dim(), tuple(field.shape))
        (got, rs), secs, ran = counted(lambda: ds.read(var, whole))
        if not torch.equal(got, field):
            raise AssertionError(f"{d.name}: read-back differs")
        if any(ran[k] < n for k, n in want.items()):
            raise AssertionError(f"{d.name}: read-back launched {ran}")
        checked = ds.verify_checksums(var)
        ds.close()
        del got
        return {"seconds": secs, "launches": ran, "checksums": checked,
                "engine": rs.engine}

    out = {"gather_batch_bytes": GATHER_BATCH_BYTES,
           "tolerance": "bit-exact: torch.equal"}
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    try:
        # 16a: slice 1's reorganization, 8192^2 f32 from merged_process
        field = torch.randn(FIELD, generator=gen, device=dev)
        src = work / "slice1_merged"
        ds = Dataset.create(str(src))
        data = {b.block_id: field[b.slices()].contiguous() for b in blocks2d}
        _, _, src_ran = counted(lambda: ds.write(
            "Ez", plan_layout("merged_process", blocks2d, num_procs=NPROCS,
                              procs_per_node=PPN), np.float32, data))
        ds.close()
        del data
        target = plan_reorganization(blocks2d, FIELD, REORG_2D,
                                     num_stagers=NPROCS // PPN)
        dst = work / "slice1_reorganized"
        (rs, dds, ws), secs, ran = counted(
            lambda: reorganize(str(src), str(dst), "Ez", target))
        dds.close()
        gen_on_disk = json.loads((dst / "index.json").read_text())[
            "generation"]
        if ran["pack_rows"] != batches(target) or gen_on_disk != 1:
            raise AssertionError(f"2-D reorganize: launches {ran}, "
                                 f"generation {gen_on_disk}")
        back = read_back(dst, "Ez", field, {"chunked_to_rowmajor": 1})
        if back["checksums"] != (len(target.chunks), []):
            raise AssertionError(f"2-D checksums: {back['checksums']}")
        out["slice1"] = {"field": list(FIELD), "scheme": list(REORG_2D),
                         "chunks": len(target.chunks), "seconds": secs,
                         "launches": ran, "source_write_launches": src_ran,
                         "generation": gen_on_disk,
                         "bytes": ws.bytes_written,
                         "stages": _reorg_stages(rs, ws),
                         "engine_write": ws.engine, "read_back": back}
        del field
        torch.cuda.empty_cache()

        # 16b: the 3-D component, the paper's patterns, in-place republish
        field = torch.randn(REORG_FIELD, generator=gen, device=dev)
        blocks = simulate_load_balance(
            uniform_grid_blocks(REORG_FIELD, REORG_BOX), num_procs=NPROCS,
            seed=SEED)
        src = work / "warpx_merged"
        ds = Dataset.create(str(src))
        merged = plan_layout("merged_process", blocks, num_procs=NPROCS,
                             procs_per_node=PPN)
        data = {b.block_id: field[b.slices()].contiguous() for b in blocks}
        wst, write_s, src_ran = counted(lambda: ds.write(
            "Ez", merged, np.float32, data))
        ds.close()
        del data
        torch.cuda.empty_cache()
        cube = {"field": list(REORG_FIELD), "box": list(REORG_BOX),
                "blocks": len(blocks), "procs": NPROCS,
                "merged_chunks": len(merged.chunks),
                "write_seconds": write_s, "write_launches": src_ran,
                "write_stages": {"lower": wst.lower_seconds,
                                 "kernel": wst.kernel_seconds,
                                 "d2h": wst.d2h_seconds,
                                 "engine_write": wst.write_seconds,
                                 "checksum_and_index": wst.total_seconds
                                 - wst.assemble_seconds - wst.write_seconds},
                "write_engine": wst.engine}
        layouts = {}
        for scheme in REORG_SCHEMES:
            layouts[scheme] = plan_reorganization(
                blocks, REORG_FIELD, scheme, num_stagers=NPROCS // PPN)
        dst = work / "warpx_reorganized"
        first = layouts[REORG_SCHEMES[0]]
        (rs, dds, ws), secs, ran = counted(lambda: reorganize(
            str(src), str(dst), "Ez", first, engine="auto"))
        dds.close()
        if ran["pack_rows"] != batches(first):
            raise AssertionError(f"3-D reorganize launched {ran} for "
                                 f"{batches(first)} batches")
        cube["reorganize"] = {
            "scheme": list(REORG_SCHEMES[0]), "chunks": len(first.chunks),
            "batches": batches(first), "seconds": secs, "launches": ran,
            "bytes": ws.bytes_written, "stages": _reorg_stages(rs, ws),
            "engine_write": ws.engine, "engine_read": ws.gather.engine,
            "read_back": read_back(dst, "Ez", field, {"pack_rows": 1})}

        patterns = {}
        for name, d in (("merged_process", src),
                        ("reorganized", dst)):
            ds = Dataset.open(str(d), engine="auto")
            if name == "merged_process":
                cube["calibration"] = ds.calibration().to_json()
            per = patterns[name] = {}
            for pat in PATTERNS:
                region = pattern_region(pat, REORG_FIELD)
                (got, _), read_s, read_ran = counted(
                    lambda: ds.read("Ez", region))
                if not torch.equal(got, field[region.slices()]):
                    raise AssertionError(f"{name}/{pat}: read differs")
                del got
                (scheme, st), pat_s, pat_ran = counted(
                    lambda: ds.read_pattern("Ez", pat,
                                            num_readers=PATTERN_READERS,
                                            engine="auto"))
                per[pat] = {"region": [list(region.lo), list(region.hi)],
                            "read_seconds": read_s,
                            "read_launches": read_ran,
                            "best_scheme": list(scheme),
                            "seconds": st.seconds,
                            "sweep_seconds": pat_s,
                            "sweep_launches": pat_ran,
                            "bytes_read": st.bytes_read,
                            "chunks_touched": st.chunks_touched,
                            "runs": st.runs, "groups": st.groups,
                            "engine": st.engine,
                            "engine_reason": st.engine_reason,
                            "predicted_seconds": st.predicted_seconds,
                            "stages": {"engine_read_and_wait": st.seconds
                                       - st.lower_seconds - st.h2d_seconds
                                       - st.linearize_seconds,
                                       "lower": st.lower_seconds,
                                       "h2d": st.h2d_seconds,
                                       "kernel": st.linearize_seconds}}
                torch.cuda.empty_cache()
            ds.close()
        cube["patterns"] = patterns
        cube["num_readers"] = PATTERN_READERS

        # 16c: layout="auto" over the history the pattern reads logged;
        # the history is kept as phase 17a's prior
        AccessLog(str(src)).export_prior(str(STAGING_PRIOR))
        auto = work / "warpx_auto"
        (rs, dds, ws), secs, ran = counted(lambda: reorganize(
            str(src), str(auto), "Ez", "auto", engine="auto"))
        decision = dds.index.attrs["policy"]["Ez"]
        sizes = [r.nbytes for r in dds.index.chunks_of("Ez")]
        dds.close()
        n_batches, size = 0, GATHER_BATCH_BYTES + 1
        for nb in sizes:                  # gather_batches' rule
            if size + nb > GATHER_BATCH_BYTES:
                n_batches, size = n_batches + 1, 0
            size += nb
        raw = decision["codec"] == "none"
        # one launch a gather batch, and one for the part read that
        # samples the codecs' ratios
        if raw and ran["pack_rows"] != n_batches + 1:
            raise AssertionError(f"auto reorganize launched {ran} for "
                                 f"{n_batches} batches")
        cube["auto"] = {
            "decision": decision, "chunks": len(sizes), "seconds": secs,
            "launches": ran, "bytes": ws.bytes_written,
            "stages": _reorg_stages(rs, ws),
            "engine_write": ws.engine, "engine_reason": ws.engine_reason,
            "read_back": read_back(auto, "Ez", field,
                                   {"pack_rows": 1} if raw else {})}
        shutil.rmtree(auto)

        # in place: a session opened before the commit refreshes onto it
        second = layouts[REORG_SCHEMES[1]]
        before = Dataset.open(str(dst))
        g0 = before.generation
        (rs, dds, ws), secs, ran = counted(lambda: reorganize(
            str(dst), str(dst), "Ez", second, engine="auto"))
        dds.close()
        refreshed = before.refresh()
        if not refreshed or before.generation != g0 + 1 or \
                ran["pack_rows"] != batches(second):
            raise AssertionError(f"in-place reorganize: refreshed "
                                 f"{refreshed}, generation {g0} -> "
                                 f"{before.generation}, launches {ran}")
        (got, _), _, _ = counted(lambda: before.read(
            "Ez", Block((0, 0, 0), REORG_FIELD)))
        if not torch.equal(got, field):
            raise AssertionError("in-place read-back after refresh differs")
        del got
        before.close()
        cube["in_place"] = {
            "scheme": list(REORG_SCHEMES[1]), "chunks": len(second.chunks),
            "batches": batches(second), "seconds": secs, "launches": ran,
            "generation": [g0, g0 + 1], "refreshed": refreshed,
            "stages": _reorg_stages(rs, ws),
            "read_back": read_back(dst, "Ez", field, {"pack_rows": 1}),
            "stored_bytes": sum(f.stat().st_size for f in dst.iterdir())}
        out["warpx"] = cube
        del field
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    missing = [k for k in ("pack_rows", "chunked_to_rowmajor")
               if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the reorganization path never launched "
                             f"{missing}")
    out["launches"] = launches
    return out


# -- phase 17 ------------------------------------------------------------------

#: 17a, online reorganization of the WarpX-style output: phase 16's 3-D
#: component staged for STAGED_STEPS output steps by 2 workers, queue depth
#: 2, the layout the policy picks with phase 16's history as its prior
STAGED_STEPS, STAGED_WORKERS, STAGED_DEPTH = 3, 2, 2
#: 17b, async checkpoints at full width: qwen2.5-3b trained by the Trainer
#: with an AsyncCheckpointer staging its params (14 f32 leaves, 12.3 GB)
#: under reorganized (4, 4) after each of ASYNC_SAVES steps.  One worker
#: and a queue of 1 keep at most 3 snapshots of a leaf (3.25 GB the
#: largest) and one assembled leaf beside the training step's 63.6 GB
ASYNC_SAVES, ASYNC_WORKERS, ASYNC_DEPTH = 2, 1, 1
ASYNC_SCHEME = (4, 4)


def _stage_row(r) -> dict:
    return {"step": r.step, "t_s": r.t_s, "t_w": r.t_w,
            "bytes": r.bytes_staged, "chunks": r.num_chunks,
            "engine": r.engine, "engine_reason": r.engine_reason,
            "stages": {"lower": r.lower_seconds, "kernel": r.kernel_seconds,
                       "d2h": r.d2h_seconds}, "error": r.error}


def _decision(d) -> dict:
    return {"strategy": d.strategy, "scheme": d.scheme, "codec": d.codec,
            "reason": d.reason, "scores": d.scores,
            "num_records": d.num_records,
            "num_prior_records": d.num_prior_records}


def staged(torch, dev, K, direct_s: float, posthoc_s: float) -> dict:
    """Online reorganization on the card (paper §5, the
    Strong-Staging-Coupler): phase 16's 3-D component as 1,024 boxes of a
    field on the card, staged for STAGED_STEPS output steps through
    ``StagingExecutor(plan="auto")`` with phase 16's history as prior.
    After each submit the producer advances the field in place on its own
    stream, so a staged copy that is not a snapshot shows as wrong bytes.
    Launch counts reset just before the staging and read just after; the
    §5.2 decision from the measured stage, write and producer times (the
    direct write and post-hoc reorganize of phase 16); every step read
    back and held to the field as it was at its submit."""
    from repro_torch.core import (StagingTimings, simulate_load_balance,
                                  uniform_grid_blocks)
    from repro_torch.core.blocks import Block
    from repro_torch.core.reorg import decide
    from repro_torch.io import Dataset, StagingExecutor
    work = ROOT / "build" / "chip_smoke" / "staged"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    field = torch.randn(REORG_FIELD, generator=gen, device=dev)
    blocks = simulate_load_balance(
        uniform_grid_blocks(REORG_FIELD, REORG_BOX), num_procs=NPROCS,
        seed=SEED)
    boxes = {b.block_id: field[b.slices()] for b in blocks}
    whole = Block((0, 0, 0), REORG_FIELD)
    producer = torch.cuda.Stream(dev)
    producer.wait_stream(torch.cuda.current_stream(dev))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ex = StagingExecutor(str(work), num_workers=STAGED_WORKERS,
                             queue_depth=STAGED_DEPTH, engine="auto",
                             prior=str(STAGING_PRIOR), device=dev)
        decision = ex.decision_for("Ez", blocks, REORG_FIELD)
        wants, stalls, compute = [], [], []
        K.reset_launch_counts()
        t0 = time.perf_counter()
        with torch.cuda.stream(producer):
            for step in range(STAGED_STEPS):
                wants.append(field.clone())
                stalls.append(ex.submit(step, "Ez", np.float32, "auto",
                                        boxes, blocks=blocks,
                                        global_shape=REORG_FIELD))
                # the time step: every box advanced in place
                t1 = time.perf_counter()
                field.mul_(0.5).add_(float(step + 1))
                producer.synchronize()
                compute.append(time.perf_counter() - t1)
        results = ex.drain()
        wall = time.perf_counter() - t0
        ex.close()
        launches = {k: K.launch_counts()[k] for k in COPY_KERNELS}
        peak = torch.cuda.max_memory_allocated()
        failed = [r.error for r in results if r.error]
        if failed or len(results) != STAGED_STEPS:
            raise AssertionError(f"staging failed: {failed}")
        if launches["pack_rows"] < STAGED_STEPS:
            raise AssertionError(f"the staged layout was not assembled on "
                                 f"the card: launches {launches}")
        ds = Dataset.open(str(work), device=dev)
        read_s = []
        for step, want in enumerate(wants):
            t1 = time.perf_counter()
            got, _ = ds.read(f"Ez@{step}", whole)
            torch.cuda.synchronize()
            read_s.append(time.perf_counter() - t1)
            if not torch.equal(got, want):
                raise AssertionError(f"staged step {step} differs from the "
                                     f"field at its submit")
            del got
        ds.close()
        rows = [_stage_row(r) for r in results]
        timings = StagingTimings(
            t_s=statistics.mean(r.t_s for r in results),
            t_w_stage=statistics.mean(r.t_w for r in results),
            t_w_sim=direct_s, t_r_stage=posthoc_s / 2, n=NPROCS,
            m=STAGED_WORKERS)
        t_c = statistics.median(compute)
        rec = decide(timings, t_c, STAGED_STEPS)
        return {"field": list(REORG_FIELD), "boxes": len(blocks),
                "steps": STAGED_STEPS, "num_workers": STAGED_WORKERS,
                "queue_depth": STAGED_DEPTH,
                "decision": _decision(decision),
                "per_step": rows, "stalls": stalls,
                "producer_step_seconds": compute, "wall_seconds": wall,
                "read_back_seconds": read_s, "launches": launches,
                "peak_memory_bytes": peak,
                "recommendation": {
                    "t_c": t_c, "N": STAGED_STEPS, "mode": rec.mode,
                    "blocking": rec.blocking,
                    "breakeven_N": rec.breakeven_N,
                    "u_on_the_fly": rec.utilization_on_the_fly,
                    "u_post_hoc": rec.utilization_post_hoc,
                    "timings": dict(t_s=timings.t_s,
                                    t_w_stage=timings.t_w_stage,
                                    t_w_sim=direct_s,
                                    t_r_stage=timings.t_r_stage,
                                    n=NPROCS, m=STAGED_WORKERS)},
                "tolerance": "bit-exact: torch.equal"}
    finally:
        shutil.rmtree(work, ignore_errors=True)


class _HostCopies:
    """The Trainer's checkpoint manager for phase 17b: a host copy of every
    leaf at each save (what the staged bytes are held to), then the
    AsyncCheckpointer's save, timed."""

    def __init__(self, inner):
        self.inner, self.seen, self.saves = inner, {}, []

    def save(self, step, tree):
        from repro_torch.checkpoint import flatten_pytree
        self.seen[step] = {k: v.detach().cpu()
                           for k, v in flatten_pytree(tree).items()}
        t0 = time.perf_counter()
        stall = self.inner.save(step, tree)
        self.saves.append({"step": step, "stall": stall,
                           "save_seconds": time.perf_counter() - t0})
        return stall


def async_checkpoints(torch, dev, K, direct_s: float) -> dict:
    """Async checkpoints at full width: qwen2.5-3b (flash route,
    ``remat="dots"``) trained for ASYNC_SAVES steps by ``Trainer.run``
    with an ``AsyncCheckpointer`` (reorganized ASYNC_SCHEME) as its
    checkpoint manager, saving after every step; launch counts reset just
    before the run and read after the last staged write.  Every staged
    leaf is read back and held to a host copy of the params at its step
    (AdamW updates them in place in the next step).  ``direct_s`` is the
    synchronous save of the same leaves (phase 15), the recommendation's
    direct write."""
    import dataclasses
    import itertools
    from repro_torch.checkpoint import AsyncCheckpointer
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticTokens
    from repro_torch.io import Dataset
    from repro_torch.core.blocks import Block
    from repro_torch.models import LM
    from repro_torch.train import OptimizerConfig, Trainer, adamw_init
    root = ROOT / "build" / "chip_smoke" / "async"
    shutil.rmtree(root, ignore_errors=True)
    cfg = dataclasses.replace(get_config(SERVE_ARCH), flash=True)
    model = LM(cfg)
    params = training_params(model, torch.Generator(device=dev)
                             .manual_seed(SEED + 17))
    host_batch = next(SyntheticTokens(PipelineConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab,
        seed=SEED)))
    try:
        ac = AsyncCheckpointer(str(root), reorg_scheme=ASYNC_SCHEME,
                               num_workers=ASYNC_WORKERS,
                               queue_depth=ASYNC_DEPTH, engine="auto",
                               t_w_direct=direct_s, device=dev)
        witness = _HostCopies(ac)
        trainer = Trainer(model, OptimizerConfig(**TRAIN_OPT),
                          itertools.repeat(host_batch), ckpt_manager=witness,
                          ckpt_every=1)
        opt = adamw_init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        params, opt, hist = trainer.run(params, opt, ASYNC_SAVES,
                                        log_every=0)
        t_run = time.perf_counter() - t0
        results = ac.finish()
        wall = time.perf_counter() - t0
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n_leaves = sum(1 for t in witness.seen[1].values() if t.dim())
        del params, opt, trainer, model
        torch.cuda.empty_cache()
        failed = [r.error for r in results if r.error]
        if failed or len(results) != ASYNC_SAVES * n_leaves:
            raise AssertionError(f"async saves failed: {failed}")
        if launches["pack_rows"] < len(results):
            raise AssertionError(f"staged leaves not assembled on the card: "
                                 f"{launches['pack_rows']} launches for "
                                 f"{len(results)} leaves")
        ds = Dataset.open(str(root), device=dev)
        t1 = time.perf_counter()
        for step, leaves in witness.seen.items():
            for name, want in leaves.items():
                if not want.dim():
                    continue
                got, _ = ds.read(f"{name}@{step}",
                                 Block((0,) * want.dim(), tuple(want.shape)))
                if not torch.equal(got, want.to(dev)):
                    raise AssertionError(f"{name}@{step} differs from the "
                                         f"params at its save")
                del got
        read_s = time.perf_counter() - t1
        ds.close()
        per_save = []
        for rec in witness.saves:
            mine = [r for r in results if r.step == rec["step"]]
            per_save.append({**rec, "leaves": len(mine),
                             "t_s": sum(r.t_s for r in mine),
                             "t_w": sum(r.t_w for r in mine),
                             "bytes": sum(r.bytes_staged for r in mine),
                             "chunks": sum(r.num_chunks for r in mine),
                             "stages": {k: sum(getattr(r, f"{k}_seconds")
                                               for r in mine)
                                        for k in ("lower", "kernel", "d2h")},
                             "engines": sorted({r.engine for r in mine})})
        steps = [m["step_seconds"] for _, m in hist]
        t_c = statistics.median(steps)
        rec = ac.recommendation(t_c, ASYNC_SAVES, ac.timings(results))
        return {"arch": SERVE_ARCH, "params": sum(
                    t.numel() for t in witness.seen[1].values()),
                "leaves": n_leaves, "scheme": list(ASYNC_SCHEME),
                "saves": ASYNC_SAVES, "num_workers": ASYNC_WORKERS,
                "queue_depth": ASYNC_DEPTH, "per_save": per_save,
                "step_seconds": steps, "run_seconds": t_run,
                "wall_seconds": wall, "read_back_seconds": read_s,
                "losses": [m["loss"] for _, m in hist],
                "launches": {k: launches[k] for k in COPY_KERNELS},
                "flash_launches": {k: n for k, n in launches.items()
                                   if k.startswith("flash") and n},
                "peak_memory_bytes": peak,
                "recommendation": {
                    "t_c": t_c, "N": ASYNC_SAVES, "mode": rec.mode,
                    "blocking": rec.blocking,
                    "breakeven_N": rec.breakeven_N,
                    "u_on_the_fly": rec.utilization_on_the_fly,
                    "u_post_hoc": rec.utilization_post_hoc,
                    "t_w_direct": direct_s},
                "tolerance": "bit-exact: torch.equal"}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.kernels as K
    from repro_torch.core import (plan_layout, simulate_load_balance,
                                  uniform_grid_blocks)
    dev = torch.device("cuda", 0)
    # the plain versions are f32 oracles: no TF32 in their products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = probe(torch)
    emit(0, **info)
    emit(1, **build())

    t0 = time.perf_counter()
    blocks = simulate_load_balance(uniform_grid_blocks(FIELD, BLOCK),
                                   num_procs=NPROCS, seed=SEED)
    layouts = {}
    for name in ("merged_process", "reorganized"):
        t1 = time.perf_counter()
        layouts[name] = {"plan": plan_layout(name, blocks, num_procs=NPROCS,
                                             procs_per_node=PPN)}
        layouts[name]["plan_seconds"] = time.perf_counter() - t1
    checks = check_kernels(torch, dev, layouts["merged_process"]["plan"])
    emit(2, seconds=time.perf_counter() - t0, **checks)

    t0 = time.perf_counter()
    K.reset_launch_counts()
    stages = main_path(torch, dev, blocks, layouts)
    launches = K.launch_counts()
    torch.cuda.empty_cache()
    emit(3, seconds=time.perf_counter() - t0, field=list(FIELD),
         block=list(BLOCK), components=len(COMPONENTS), procs=NPROCS,
         layouts=stages)

    t0 = time.perf_counter()
    times = timings(torch, dev, layouts["merged_process"]["plan"])
    emit(4, seconds=time.perf_counter() - t0, kernels=times,
         hbm_bytes_per_s=HBM_BYTES_PER_S)

    emit(5, launches=launches)
    missing = [k for k in KERNELS if not k.startswith("flash_attention")
               and launches[k] <= 0]
    if missing:
        raise AssertionError(f"main path never launched: {missing}")

    t0 = time.perf_counter()
    flash_check = check_flash(torch, dev)
    emit(6, seconds=time.perf_counter() - t0, **flash_check)

    t0 = time.perf_counter()
    served = serve(torch, dev, K)
    emit(7, seconds=time.perf_counter() - t0, **served)

    t0 = time.perf_counter()
    flash_times = flash_timings(torch, dev)
    emit(8, seconds=time.perf_counter() - t0, flash_attention=flash_times,
         bf16_flops=BF16_FLOPS, f32_flops=F32_FLOPS, tf32_flops=TF32_FLOPS,
         hbm_bytes_per_s=HBM_BYTES_PER_S)

    serve_launches = served["launches"]
    emit(9, launches=serve_launches)
    n_layers = served["layers"]
    if serve_launches["flash_attention"] < n_layers or \
            serve_launches["flash_attention_simt"] or \
            serve_launches["flash_attention_f32tc"] or \
            serve_launches["flash_attention_d256"]:
        raise AssertionError(
            f"serving launched the sm90 flash kernel "
            f"{serve_launches['flash_attention']} times for {n_layers} "
            f"layers, the CUDA-core one "
            f"{serve_launches['flash_attention_simt']} times, the 3xTF32 "
            f"one {serve_launches['flash_attention_f32tc']} times, the "
            f"head_dim-256 one {serve_launches['flash_attention_d256']} "
            f"times")

    t0 = time.perf_counter()
    bwd_check = check_flash_bwd(torch, dev)
    emit(10, seconds=time.perf_counter() - t0, **bwd_check)

    t0 = time.perf_counter()
    state = {}
    trained = train(torch, dev, K, hand_over=state)
    emit(11, seconds=time.perf_counter() - t0, **trained)
    check_training(trained)

    # phase 15 runs here, on phase 11's trained tree, which the later
    # phases have no room for beside their own
    t0 = time.perf_counter()
    ckpt = checkpoint(torch, dev, K, state)
    torch.cuda.empty_cache()
    emit(15, seconds=time.perf_counter() - t0, **ckpt)

    t0 = time.perf_counter()
    bwd_times = bwd_timings(torch, dev)
    emit(12, seconds=time.perf_counter() - t0, **bwd_times,
         bf16_flops=BF16_FLOPS, f32_flops=F32_FLOPS, tf32_flops=TF32_FLOPS,
         hbm_bytes_per_s=HBM_BYTES_PER_S)

    t0 = time.perf_counter()
    gemma2 = serve(torch, dev, K, GEMMA2_ARCH, training_params)
    emit(13, seconds=time.perf_counter() - t0, **gemma2)
    check_gemma2_serving(gemma2)

    t0 = time.perf_counter()
    trained_g = train(torch, dev, K, GEMMA2_ARCH)
    emit(14, seconds=time.perf_counter() - t0, **trained_g)
    check_training(trained_g)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    reorganized = reorg(torch, dev, K, blocks)
    emit(16, seconds=time.perf_counter() - t0, **reorganized)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cube = reorganized["warpx"]
    online = staged(torch, dev, K, cube["write_seconds"],
                    cube["reorganize"]["seconds"])
    emit("17a", seconds=time.perf_counter() - t0, **online)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    saves = async_checkpoints(torch, dev, K, ckpt["save"]["params_seconds"])
    emit("17b", seconds=time.perf_counter() - t0, **saves)
    emit("total", seconds=time.perf_counter() - t_start)

    # the copy kernels' launches on their five paths: the slice-1 step
    # (phase 3), the checkpoint path (phase 15), the reorganization path
    # (phase 16), the staged output (phase 17a) and the async checkpoints
    # (phase 17b)
    rows = [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "launches": launches[name] + ckpt["launches"][name]
             + reorganized["launches"][name] + online["launches"][name]
             + saves["launches"][name],
             "max_abs_err": checks["max_abs_err"][name],
             "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
             "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": times[name]["library_ms"]}
            for name, (source, replaces) in KERNELS.items()
            if not name.startswith("flash_attention")]
    # the sm90 forward's two kernels on the serving runs (qwen2.5-3b's
    # head_dim 128, gemma2-2b's 256); the 3xTF32 forward on the f32
    # serving prefill, the path that runs it here.  The CUDA-core forward
    # runs on no path, so the summary, the kernels of the paths, leaves it
    # out: phase 6 checks it against its plain version, phase 8 times it
    for name, launched, t in (
            ("flash_attention", serve_launches["flash_attention"],
             flash_times["serving"]),
            ("flash_attention_d256", gemma2["launches"]["flash_attention_d256"],
             flash_times["gemma2"]),
            ("flash_attention_f32tc", served["flash_vs_q_chunked"]["float32"]
             ["flash_launches"]["flash_attention_f32tc"],
             flash_times["f32_serving"])):
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched,
                     "max_abs_err": flash_check["max_abs_err"][name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # the sm90 backward on the training runs (qwen2.5-3b's head_dim 128,
    # gemma2-2b's 256); the 3xTF32 backward on qwen2.5-3b's f32 route
    # comparison, the path that runs it here.  The CUDA-core backward runs
    # on no path: phase 10 checks it, phase 12 times it
    f32_launches = trained["flash_vs_q_chunked"]["float32"]["flash_launches"]
    for name, launched, t in (
            ("flash_attention_dq", trained["launches"]["flash_attention_dq"],
             bwd_times["training"]["flash_attention_dq"]),
            ("flash_attention_dq_d256",
             trained_g["launches"]["flash_attention_dq_d256"],
             bwd_times["gemma2"]["flash_attention_dq_d256"]),
            ("flash_attention_dq_f32tc",
             f32_launches["flash_attention_dq_f32tc"],
             bwd_times["training_f32"]["flash_attention_dq_f32tc"]),
            ("flash_attention_dkv", trained["launches"]["flash_attention_dkv"],
             bwd_times["training"]["flash_attention_dkv"]),
            ("flash_attention_dkv_d256",
             trained_g["launches"]["flash_attention_dkv_d256"],
             bwd_times["gemma2"]["flash_attention_dkv_d256"]),
            ("flash_attention_dkv_f32tc",
             f32_launches["flash_attention_dkv_f32tc"],
             bwd_times["training_f32"]["flash_attention_dkv_f32tc"])):
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched,
                     "max_abs_err": bwd_check["max_abs_err"][name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
