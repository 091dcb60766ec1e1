#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root, on a machine with a CUDA card and ``nvcc``:

    python3 chip_smoke.py

or, for phase 22 alone (after phases 0 and 1; it is not in the default
run, for its memory and its time, see below):

    python3 chip_smoke.py --moe-serving

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
   summary's copy-kernel rows add the launches of phases 15-19 and 20c);
6. the flash-attention forward's kernels against their plain version on
   the card, within tolerance: masks, GQA groups of 1, 2, 4, 5 and 8,
   head dims 16-256 (padded ones too), ragged lengths, f32 and bf16, the
   serving paths' shapes (qwen2.5-3b's in bf16 and f32, gemma2-2b's,
   hymba-1.5b's groups of 5 under a window of 1024, hubert-xlarge's
   non-causal head_dim 80, llama-3.2-vision-90b's 64 q-heads over 8)
   with scores of std 2, and two more bf16 cases (D 80 at L 200; D 128
   at L 2048 with a window of 512 and a softcap); the launch counts show
   that each bf16 case ran the sm90 route (``csrc/flash_fwd_sm90.cu`` up
   to head_dim 128, ``csrc/flash_fwd_sm90_d256.cu`` above) and each f32
   case the 3xTF32 tensor-core kernel (``csrc/flash_fwd_f32tc.cu``), each
   route's total equal to the cases sent to it; the CUDA-core kernel
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
   cores), the plain version and SDPA in f32; and the sm90 route at
   hymba-1.5b's shape beside SDPA with the window as a mask, at
   hubert-xlarge's training shape (non-causal) and at the VLM's self
   layers' beside SDPA;
9. launch counts of the serving run; the sm90 kernel must have run once
   per layer at least, the head_dim-256, 3xTF32 and CUDA-core forwards
   never;
10. the flash-attention backward kernels (dQ, and per-q-head dK, dV)
    against their plain versions on the card, within tolerance, over the
    forward's sweep (GQA groups of 1, 2, 4, 5 and 8), the training shape
    and gemma2-2b's full-length shape given as strided views in bf16 and
    in f32 (the training shape's f32 inputs also on the CUDA-core route,
    named), hubert-xlarge's training shape (non-causal, head_dim 80) in
    bf16, and
    ``flash_attention``'s gradients against autograd through the plain
    forward; the launch counts show that each bf16 case ran the sm90
    kernels (``csrc/flash_bwd_sm90.cu`` up to head_dim 128,
    ``csrc/flash_bwd_sm90_d256.cu`` above) and each f32 case the 3xTF32
    ones (``csrc/flash_bwd_f32tc.cu``), the named case the CUDA-core ones
    (``csrc/flash_bwd.cu``), and each route's count equals the cases the
    sweep sends it;
11. the training path at full width: qwen2.5-3b (6 of its 36 layers,
    ``QWEN_TRAIN_DEPTH``; random weights from a seed: see
    ``training_params``; ``remat="dots"``) with the flash route on, at
    global batch 2 x 2048 tokens from the synthetic pipeline: first, on
    the same model cut to ``COMPARE_DEPTH`` layer steps a stacked segment
    (``cut_depth``: the kernels' shapes stay the full model's), the flash
    route's loss and gradients against the q-chunked route's (f32 and
    bf16 compute; the bf16 route's backward runs the sm90 kernels, the
    f32 one the 3xTF32 kernels after the 3xTF32 forward) and a profile of
    one training step; then ``Trainer.run`` for 4 AdamW steps on one
    batch (``TRAIN_OPT``), launch counts reset just before it and read
    just after (6 sm90 dq and 6 sm90 dkv launches a step, none on the
    CUDA-core route), the step times and peak memory;
12. the backward kernels' times (as phase 4's): at the training shape and
    at gemma2-2b's bf16 head_dim-256 shape the sm90 kernels beside the
    CUDA-core kernels on the same bf16 inputs, their bound, the plain
    versions and the backward of ``scaled_dot_product_attention`` (its
    kernels' device time from the profiler: autograd's host work outlasts
    them); and at both shapes on f32 inputs, those of the f32 route
    comparisons, the 3xTF32 kernels beside the CUDA-core ones, both
    bounds (3xTF32 and f32 on the CUDA cores) and SDPA's backward in f32;
    and at hymba-1.5b's training shape (B 2, GQA groups of 5, head_dim 64,
    window 1024) the sm90 kernels beside their bound and SDPA's backward
    with the window as a boolean mask; and at hubert-xlarge's (non-causal,
    head_dim 80) beside their bound and SDPA's backward;
13. the serving path at gemma2-2b's full width (26 layers, head_dim 256,
    local and global layers, softcaps; random weights: see
    ``training_params``), as phase 7 serves qwen2.5-3b: the bf16 prefill
    launches the sm90 route's head_dim-256 kernel once per layer and the
    CUDA-core forward never, the f32 route comparison the 3xTF32 forward
    once per layer, and the profile names the flash forward's device time
    in the prefill;
14. the training path at gemma2-2b's full width and 8 of its 26 layers
    (4 ``pair_lg`` steps: the kernels' shapes are the full model's), as
    phase 11 trains qwen2.5-3b (the same traffic, steps and checks, the
    route comparison and the profile at 2 ``pair_lg`` steps): 8
    launches a step of each head_dim-256 sm90 backward kernel
    (``csrc/flash_bwd_sm90_d256.cu``), 16 of the head_dim-256 forward,
    none on a CUDA-core route; the f32 route comparison runs the 3xTF32
    forward and backward once per layer, and the profile
    names the flash backward's device time in a step;
15. (run right after phase 11, on its trained tree: the later phases have
    no room for it beside their own) the checkpoint path at full width:
    qwen2.5-3b's params and AdamW state (42 f32 leaves, 6 of its 36
    layers: about 9.3 GB, and the int32 step count) saved by
    ``CheckpointManager`` under ``merged_process`` into
    ``build/chip_smoke/ckpt`` from ``MeshSharding``s of 2 simulated
    hosts x 4 devices (each leaf split 8 ways, the blocks from
    ``blocks_from_sharding``: 2 chunks a leaf, one ``pack_rows`` launch a
    leaf at least), restored whole onto the card
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
    source) and by ``read_pattern`` with 4 readers and
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
    exported as 17a's prior.  Before 16c, under each of the two layouts
    (16d), the multi-tenant read service (``ReadService``, default 2 ms
    window, ``max_batch`` 64, 256 MiB in flight, ``engine="auto"``):
    8 tenant threads each submit the regions of ``sub_area``,
    ``plane_yz``, ``plane_xz``, ``plane_xy`` and ``line_z`` (round B:
    tenant t's moved 8 t along axis 0, clamped to the domain), then one
    ``read_batch`` of round B's 40 requests and
    one of round C's 16 (each tenant's ``line_z`` and ``plane_yz``,
    moved as in round B, which fit the in-flight limit together: fewer
    coalesced batches than requests, or the phase fails); every result
    ``torch.equal`` to the source on the card, ``pack_rows`` launches
    equal to the coalesced batches (``super_plans``), no member on the
    host route; the service's statistics, ``fetch_bytes`` against
    ``bytes_served``, each tenant's seconds, and each ``read_batch``'s
    wall time beside the same requests as independent ``Dataset.read``
    calls;
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
17b. async checkpoints at full width: qwen2.5-3b at 6 of its 36 layers
    (``ASYNC_TRAIN_DEPTH``) trained for 2 steps by
    ``Trainer.run`` with an ``AsyncCheckpointer`` (``reorganized`` (4,
    4), 1 worker, queue depth 1) as its checkpoint manager, which stages
    the params (14 f32 leaves, 3.09 GB) after each step; per save the
    stall, ``t_s``, ``t_w`` and stages, the recommendation (the direct
    write: a synchronous save of these params as phase 15 saves its tree,
    timed before the run), the launches of the run,
    the peak memory; every staged leaf read back ``torch.equal`` to a host
    copy of the params at its save; the directory removed;
18. (after 17b) the kernel-bypass engines and the distributed fleet on the
    card.  18a: the probes (``uring_available``, ``odirect_available``)
    and the calibration's kernel terms for ``build/chip_smoke/engines``;
    phase 16's 3-D component written under ``merged_process`` with
    ``engine="odirect"`` and ``engine="uring"`` and read back whole onto
    the card, the first copy with ``pread`` and ``odirect``, the second
    with ``uring`` and ``uring`` with ``direct=True`` (the direct reads
    are cold whatever the page cache holds), and slice 1's component
    under ``reorganized`` 8 x 8 written and read back through O_DIRECT:
    each transfer's seconds, GB/s, the engine that ran and its reason, the
    uring pool's registration.  18b:
    ``distributed_reorganize`` of the 3-D component to ``reorganized`` 4 x
    4 x 4 with O_DIRECT writes and 2 worker processes gathering on the
    card: a first fleet whose first worker parked at ``mid_write`` is
    SIGKILLed (lease 3 s), the survivor finishing every unit, then
    ``distributed_reorganize`` adopting the journal, validating and
    committing.  Per surviving worker the units done and lost, chunks
    gathered, ``pack_rows`` launches (read in the worker, after its
    warm-up), the card's name and the spawn, import, warm-up and work
    seconds; the destination bit-identical to a single-process
    ``reorganize`` and read back ``torch.equal``;
19. trace replay: every committed trace under ``traces/`` replayed
    by ``replay_trace`` with ``engine="memmap"`` on the card and on the
    CPU under ``build/chip_smoke/replay`` (removed): the two digests equal
    (the digest covers every read's bytes, every policy decision and the
    final index and manifest tables), the event counts the trace's own,
    nonzero verified bytes; each trace's seconds both ways and its
    copy-kernel launches on the card (``pack_rows`` in every trace, the
    relayout pair where a replayed read or write meets an even 2-D grid);
20. the SSD and hybrid families at full width and depth, served as
    phase 7 serves qwen2.5-3b (4 prompts of 2048 tokens, 32 new tokens),
    each then checked decode against forward in f32 compute (prefill 255
    tokens, decode the 256th, max |d| / max |ref| < 0.05).  20a:
    mamba2-780m (48 SSD layers): no flash kernel may launch.  20b:
    hymba-1.5b (32 layers of parallel attention and SSM heads, 25 q-heads
    over 5 kv-heads, windows of 1024 but in 3 layers): the bf16 prefill
    launches the sm90 forward once a layer, the f32 comparison the 3xTF32
    forward once a layer, none other, and the flash route's logits stay
    within 2e-2 of the q-chunked route's.  20c: hymba-1.5b's live serving
    state (its f32 params and a prefill's cache: ring and full bf16 KV,
    the f32 SSM state, the bf16 conv window) saved by
    ``CheckpointManager`` under ``merged_process`` into
    ``build/chip_smoke/serve_snap`` and restored onto the card, every leaf
    ``torch.equal``, then 8 greedy tokens decoded from the restored state
    equal to those from the original; save and restore seconds, bytes,
    chunks and copy-kernel launches; the directory removed;
21. the SSD and hybrid families trained at full width (mamba2-780m at
    ``SSM_TRAIN_DEPTH`` of its 48 layers, hymba-1.5b whole), as phase 11
    trains qwen2.5-3b (2 x 2048 tokens, ``remat="dots"``, 4
    AdamW steps on one batch; the route comparison and a profiled step at
    2 layer steps a stacked segment): 21a mamba2-780m (no attention: no
    route comparison, and no flash kernel may launch), 21b hymba-1.5b (the
    f32 and bf16 route comparisons at 7 of its 32 layers, its 3
    single-layer segments kept; 32 sm90 dq and 32 sm90 dkv launches a
    step, 61 of the sm90 forward: those 3 segments run without remat, as
    in the reference); every
    loss and grad norm finite (the SSD's chunk of 256 gave nan gradients
    before its exponent was masked), the last loss below the first;
22. only with ``--moe-serving``: deepseek-moe-16b at full width and depth
    (28 layers of 64 routed and 2 shared experts, MHA head_dim 128;
    16.9e9 f32 params), served as phase 7 serves qwen2.5-3b: 28 sm90
    forward launches a bf16 prefill, the route comparison with the
    routing decisions that differ between the routes counted: in f32 the
    whole model's logits held to LOGIT_GAP; in bf16 each of the 28
    layers' attention held to LOGIT_GAP on the input (its ``ln1`` output)
    the q-chunked prefill gave it, run again on both routes, and the whole
    model's gap reported, not gated (bf16 compute settles routing
    near-ties apart and the flips cascade: 0.0703 on an H100); decode
    against forward at capacity factor 16, a profile, and the phase's peak
    device memory under 80 GiB;
23. the encoder trained at full width and depth: hubert-xlarge (48
    ``enc`` layers, d_model 1280, 16 heads of 80, frames in), as phase 11
    trains qwen2.5-3b (2 x 2048 frames of the pipeline); its frames enter
    in bf16 whatever the compute dtype, so the route comparison runs once,
    in bf16, on the sm90 kernels (no 3xTF32 launch), its gradients held
    to GRAD_GAP_BF16; 48 sm90 dq, 48 sm90 dkv and 96 sm90 forward
    launches a step (non-causal, head_dim 80), none on another route; then
    one ``LM.prefill`` over 4 x 2048 frames timed (48 sm90 forward
    launches) and the flash route's logits at every frame held to the
    q-chunked route's within LOGIT_GAP;
24. cross-attention and the VLM: llama-3.2-vision-90b at full width and
    one of its 20 ``group_sx`` steps (4 self layers and 1 gated cross
    layer, 6.4e9 f32 params; the whole model does not fit a card), served
    as phase 7 serves qwen2.5-3b with memory tokens of 0.02·N(0, 1) in
    bf16 (4 x 6404 x 8192) through ``generate(extra=)`` and every gate at
    ``XATTN_GATE``: 4 sm90 forward launches a bf16 prefill and 4 of the
    3xTF32 forward in the f32 comparison (the cross layer is plain
    attention), both route gaps under LOGIT_GAP, decode against forward
    (< 0.05), and the phase's peak device memory under 80 GiB;
25. MoE training: deepseek-moe-16b at full width and 4 of its 28 ``moe``
    layers (2.77e9 f32 params), as phase 11 trains qwen2.5-3b: the f32
    route comparison at 2 layers gated whole (GRAD_GAP_F32 per leaf); in
    bf16 each layer's attention on the input the q-chunked route gave it
    (``layer_attention_grad_gaps``: the backward kernels against their
    plain versions at BWD_TOL, and the layer's input and weight gradients
    of both routes within GRAD_GAP_BF16), the whole-model gaps and the
    routing decisions that differ reported, not gated; 8 sm90 forward, 4
    dq and 4 dkv launches a step, none else; peak under 80 GiB;
26. the distributed slice in a world of 2 spawned ranks on the one card
    (gloo over CUDA tensors, the functional collectives' kernels replaced
    by the classic c10d calls: ``classic_dtensor_collectives``): which
    collectives gloo takes on CUDA tensors; (a) deepseek-moe-16b at full
    width and 2 layers on mesh (data 1, model 2), ``dispatch="local"``,
    f32, under the config's ``remat="dots"``: the seeded params placed by
    ``DEFAULT_RULES`` (8 of 16 heads, 32 of 64 experts and half the
    vocabulary a rank), one ``make_train_step`` step against the same
    step without a mesh on each rank: the loss within 1e-5 relative and
    every AdamW first moment (0.1 x the clipped gradient) within 1e-4 of
    its max; each rank's per-shard flash launches (the 3xTF32 kernels at
    8 heads, the forward twice a layer: the recompute); then in bf16
    ``_flash_sharded`` at the model's attention shape, one sm90 forward,
    dq and dkv a rank at 8 heads, each rank's blocks within BWD_TOL of
    the unsharded kernels'; then one bf16 ``make_train_step`` with remat
    on the mesh held to rank 0's unsharded bf16 step
    (``_sharded_step_bf16``: the loss within 1e-2, each layer's attention
    input gradient and attention weights' first moments within
    GRAD_GAP_BF16, the routing decisions that differ reported; its sm90
    launches on the kernels line); (c) those params through
    ``CheckpointManager`` under ``merged_process`` (rank 0 writes,
    ``pack_rows`` merging), restored onto their placements, every rank's
    block ``torch.equal`` to its own, and the blocks those
    ``MeshSharding`` gives; (b) the model at 1 layer on mesh (data 2,
    model 1): ``make_train_step_reduce_once`` with 2 microbatches of one
    2048-token row on each rank against rank 0's unsharded gradients over
    the same 4 rows (every leaf but the router's within 1e-4; the
    router's gap reported), ``compressed_psum_tree`` on the attention and
    router gradients bit-equal to the same call on CPU copies,
    ``reduce_scatter_then_gather`` equal to an all-reduce, and the step's
    update (``step.apply``) from those gradients with replicated moments
    and, on a copy of the params, with ZeRO-1 moments split over "data"
    (``adamw_init(zero1=True)``): the params bit-equal, each rank's m and
    v half the bytes; the card's memory in use, both ranks', under 75 GB;
27. the launch tooling: (a) phase 11's step (qwen2.5-3b at 6 layers, 2 x
    2048 tokens, bf16, remat, flash) traced fake through
    ``launch/specs.build_cell`` and ``launch/dryrun.trace`` and counted on
    the card by ``launch/op_analysis.analyze_ops``: the fake trace's flops
    equal to the real step's, its predicted peak beside
    ``max_memory_allocated``, and the step's model TFLOP/s and MFU
    (``model_flops_estimate`` over the median step seconds and over 989.4
    TFLOP/s) printed on a line of its own; (b) ``python -m
    repro_torch.launch.dryrun`` on qwen2.5-3b x decode_32k at full width
    and depth in a fake (16, 16) world (a subprocess started before phase
    23): status ok, its per-device peak under 80 GiB.

The last lines are the script's total seconds, the kernel summary, the
card's name and power limit, and ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; without a CUDA device the script exits
non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
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
#: the flash kernels' plain versions are timed in fewer calls
#: (``time_plain``)
PLAIN_REPS, PLAIN_ROUNDS = 2, 3

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
#: and at hymba-1.5b's: 25 q-heads over 5 kv-heads (GQA groups of 5, B·Hq
#: 100), head_dim 64, its config's window of 1024
FLASH_HYMBA = dict(B=4, Hq=25, Hkv=5, L=2048, D=64, causal=True,
                   window=1024, softcap=None)
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

#: the training path: qwen2.5-3b, global batch 2 x 2048 tokens, 4 steps
#: (the steady step is the median of steps 2-4)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 4
#: phase 14 trains gemma2-2b at its full width and 4 of its 13 ``pair_lg``
#: steps (8 of 26 layers): the head_dim-256 kernels run at their real
#: shapes, the launch counts follow the layer count
GEMMA2_TRAIN_DEPTH = 4
#: phase 11 trains qwen2.5-3b at its full width and 6 of its 36 layers,
#: and phase 15 checkpoints that tree (the whole model's is 37.03 GB); 17b
#: trains and stages 6 of them.  (At 24 and 12 layers, a 25.93 GB
#: checkpoint of 46-50 s and 23-36 s of staged saves, and at 12 and 6,
#: the run did not fit its budget beside phases 25 and 26.)
QWEN_TRAIN_DEPTH, ASYNC_TRAIN_DEPTH = 6, 6
#: phase 21a trains mamba2-780m at its full width and 24 of its 48 layers
SSM_TRAIN_DEPTH = 24
#: AdamW for the training run.  Its first steps move each of the 3.1e9
#: weights by about lr whatever its gradient's size; with a 2-step warmup
#: to 3e-4 the loss went (6 steps) 12.25, 8.91, 16.65, 16.39, 17.93, 13.68 on the
#: flash route and 12.25, 8.91, 16.70, 16.43, 17.89, 14.10 on the
#: q-chunked route (an H100 80GB HBM3 at 700 W, tools/train_lr_probe.py):
#: AdamW's overshoot, not the kernels'.  A 100-step warmup to the same
#: peak went 12.25 -> 7.63.
TRAIN_OPT = dict(peak_lr=3e-4, warmup_steps=100, total_steps=1000)
FLASH_TRAIN = dict(B=TRAIN_BATCH, Hq=16, Hkv=2, L=TRAIN_SEQ, D=128,
                   causal=True, window=None, softcap=None)
#: hymba-1.5b's training shape (phase 21b's windowed layers): GQA groups
#: of 5, head_dim 64, a window of 1024
FLASH_HYMBA_TRAIN = dict(FLASH_HYMBA, B=TRAIN_BATCH)
#: hubert-xlarge's training shape (phase 23): 16 heads of 80 (MHA), its
#: encoder bidirectional, so every (q, k) pair is live
FLASH_HUBERT = dict(B=TRAIN_BATCH, Hq=16, Hkv=16, L=TRAIN_SEQ, D=80,
                    causal=False, window=None, softcap=None)
#: deepseek-moe-16b's training shape (phase 25): 16 heads of 128 over 16
#: (MHA), causal
FLASH_MOE_TRAIN = dict(B=TRAIN_BATCH, Hq=16, Hkv=16, L=TRAIN_SEQ, D=128,
                       causal=True, window=None, softcap=None)
#: llama-3.2-vision-90b's self layers at the serving shape (phase 24): 64
#: q-heads over 8 kv-heads, head_dim 128
FLASH_VLM = dict(B=4, Hq=64, Hkv=8, L=2048, D=128, causal=True,
                 window=None, softcap=None)
#: flash vs q-chunked training gradients in f32: max |d| / max |q-chunked|
#: per leaf; the loss in bf16 compute: |d| / |q-chunked|
GRAD_GAP_F32, LOSS_GAP_BF16 = 1e-3, 1e-2
#: the same gradient gap in bf16 compute, gated where a model has no f32
#: route (a frames model: its frames enter in bf16 whatever the compute
#: dtype).  Each route rounds its bf16 products on its own, a few bf16
#: steps (2^-8) of a leaf's max: qwen2.5-3b's largest bf16 gap was 1.45e-2
#: on an H100 (PERF.md), hubert-xlarge's smoke model's on the CPU 1.3e-2
GRAD_GAP_BF16 = 5e-2
#: the route comparisons and the profiled training step run on the model
#: cut to at most this many layer steps a segment (``cut_depth``): every
#: kernel at the full model's shapes, every layer kind, a fraction of the
#: time and of the profiler's events
COMPARE_DEPTH = 2

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


def time_ms(fn, reps: int = REPS, rounds: int = 5, warm: int = 3) -> dict:
    """Device time of one call: CUDA events around ``rounds`` runs of
    ``reps`` back-to-back calls after ``warm`` calls, each run divided by
    ``reps``, so the host's work between launches (the wrapper's checks,
    allocation, tensor maps) overlaps the device's and is not counted as
    the kernel's: the median and the quartiles, in milliseconds."""
    import torch
    for _ in range(warm):
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


def time_plain(fn) -> dict:
    """``time_ms`` of a flash kernel's plain version, which takes 4-31 ms a
    call at the timed shapes: PLAIN_ROUNDS runs of PLAIN_REPS calls after
    one warm-up call (7 calls, not 103)."""
    return time_ms(fn, reps=PLAIN_REPS, rounds=PLAIN_ROUNDS, warm=1)


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call: the summed device time of its kernels
    under ``torch.profiler`` over ``reps`` calls after a warm-up, per call.
    For a call whose host work outlasts its kernels (autograd's backward),
    where events would time the host."""
    import torch
    from torch.autograd import DeviceType
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / reps


def device_profile():
    """``torch.profiler`` over the card's activity only: every reading
    here is a kernel's device time, and recording the host's operators as
    well took seconds to aggregate a profile of a few thousand kernels
    and stretched the host clock under it."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


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
    their register budget, must not spill.  While ``nvcc`` runs, one
    empty ``device_profile`` window pays the profiler's first-use
    set-up (seconds of host work) that the first profiled phase would
    pay otherwise."""
    from concurrent.futures import ThreadPoolExecutor
    import torch
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(_build.build_all)
        with device_profile():
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        profiler_s = time.perf_counter() - t0
        info = job.result()
    for name in _build.SOURCES:
        _build.load(name)
    libs = {n: {"seconds": v["seconds"], "ptxas": ptxas_report(v["log"])}
            for n, v in info.items()}
    for n, v in libs.items():
        if n.endswith(("_sm90", "_sm90_d256", "_f32tc")) and \
                v["ptxas"]["spills"]:
            raise RuntimeError(f"{n} spills: {v['ptxas']['spills']}")
    return {"seconds": time.perf_counter() - t0, "libs": libs,
            "profiler_setup_seconds": profiler_s}


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
            for g in (1, 2, 4, 5, 8):
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
    # bf16 on the sm90 route (gemma2's on its head_dim-256 kernel, hymba's
    # GQA groups of 5 on the head_dim-128 one, hubert-xlarge's non-causal
    # head_dim 80, the VLM's 64 q-heads over 8); f32 at
    # the serving prefill's and gemma2-2b's shapes on the 3xTF32 route; the
    # CUDA-core forward, which no path runs now, named at the serving shape
    for name, shp, dtype, want, named in (
            ("serving", FLASH_MAIN, torch.bfloat16, "sm90", None),
            ("gemma2", FLASH_GEMMA2, torch.bfloat16, "sm90", None),
            ("hymba", FLASH_HYMBA, torch.bfloat16, "sm90", None),
            ("d80", FLASH_D80, torch.bfloat16, "sm90", None),
            ("long_window", FLASH_LONG_WINDOW, torch.bfloat16, "sm90", None),
            ("hubert", FLASH_HUBERT, torch.bfloat16, "sm90", None),
            ("vlm", FLASH_VLM, torch.bfloat16, "sm90", None),
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

def serve(torch, dev, K, arch=SERVE_ARCH, init=None, hand_over=None,
          depth=None, extra=None) -> dict:
    """``ServeEngine.generate`` on the full ``arch`` with the flash route
    on, weights from ``init`` (by default ``serving_params``); the launch
    counts of that one call; then the flash route's prefill logits against
    the q-chunked route's on the same weights and prompts, in the model's
    bf16 compute and in f32, each held to LOGIT_GAP, each flash prefill's
    launches read on their own: one per self-attention layer
    (``self_attention_layers``) on the kernel of the route its dtype takes
    (``flash_kernel``), none on any other; the first route's cache is
    freed before the second prefill.  For an MoE model the experts each
    route's prefill picks are compared too (routing is discrete: a
    near-tie that the two routes' rounding settles apart sends a token to
    another expert, and the flip cascades), the counts that differ
    reported beside the gap; its bf16 gap is reported, not gated, and each
    layer's attention is held to LOGIT_GAP instead, on the input the
    q-chunked prefill gave it (``layer_attention_gaps``).  A model without
    attention (mamba2-780m) has no second route: its prefill must launch
    no flash kernel.  ``depth`` cuts each segment to that many layer steps
    (``cut_depth``); ``extra`` joins every prefill's batch (a VLM's memory
    tokens).  With a ``hand_over`` dict
    the model and its params go into it instead of being freed."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine, cache_bytes
    cfg = dataclasses.replace(get_config(arch), flash=True)
    if depth is not None:
        cfg = cut_depth(cfg, depth)
    if PROMPT_LEN % cfg.flash_block:
        raise ValueError("the prompts must take the flash route")
    extra = extra or {}
    model = LM(cfg)
    t0 = time.perf_counter()
    params = (init or serving_params)(model, torch.Generator(device=dev)
                                      .manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    max_len = PROMPT_LEN + NEW_TOKENS
    engine = ServeEngine(model, params, max_len=max_len)
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab, (SERVE_BATCH, PROMPT_LEN))
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    spans = {}
    t0 = time.perf_counter()
    out, stats = engine.generate(prompts, NEW_TOKENS, extra=extra)
    spans["generate"] = time.perf_counter() - t0
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if out.shape != (SERVE_BATCH, NEW_TOKENS) or out.min() < 0 or \
            out.max() >= cfg.vocab:
        raise AssertionError(f"generated tokens out of range: {out.shape}, "
                             f"[{out.min()}, {out.max()}]")
    _, again = engine.generate(prompts, NEW_TOKENS, extra=extra)

    t0 = time.perf_counter()
    batch = {"tokens": torch.as_tensor(prompts, device=dev), **extra}
    routes = {}
    n_attn = self_attention_layers(cfg)
    base = LM(dataclasses.replace(cfg, flash=False))
    for dtype in (torch.float32, torch.bfloat16) if n_attn else ():
        per_layer = dtype == torch.bfloat16 and cfg.moe is not None
        with compute_dtype(dtype), torch.inference_mode():
            K.reset_launch_counts()
            with routing_log(cfg) as flash_picks:
                flash_logits = model.prefill(params, batch)[0]
            flash_launches = K.launch_counts()
            with routing_log(cfg) as base_picks, \
                    attention_inputs(per_layer) as inputs:
                base_logits = base.prefill(params, batch)[0]
        for lg in (flash_logits, base_logits):
            if not torch.isfinite(lg).all():
                raise AssertionError("non-finite prefill logits")
        # bf16 compute runs the sm90 route, f32 the 3xTF32 kernel
        route = "sm90" if dtype == torch.bfloat16 else "f32tc"
        kernel = flash_kernel("fwd", route, cfg.head_dim)
        ran = {n: flash_launches[n] for n in FLASH_KERNELS}
        want = {n: n_attn * (n == kernel) for n in FLASH_KERNELS}
        if ran != want:
            raise AssertionError(f"{dtype} flash prefill: launches {ran}, "
                                 f"expected {want} (one {kernel} launch per "
                                 f"self-attention layer)")
        routes[str(dtype).split(".")[-1]] = r = {
            "logit_gap": float((flash_logits - base_logits).abs().max()
                               / base_logits.abs().max()),
            "gated": not per_layer,
            "same_greedy_first_token_share": float(
                (flash_logits.argmax(-1) == base_logits.argmax(-1))
                .float().mean()),
            "flash_launches": flash_launches}
        if base_picks:
            r.update(routing_differences(flash_picks, base_picks,
                                         cfg.moe.n_experts))
        if per_layer:
            with compute_dtype(dtype):
                r["per_layer"] = layer_attention_gaps(torch, K, inputs,
                                                      kernel)
        del flash_picks, base_picks, inputs
    for name, r in routes.items():
        if r["gated"] and r["logit_gap"] >= LOGIT_GAP:
            raise AssertionError(
                f"{name}: flash route's prefill logits differ from the "
                f"q-chunked route's by {r['logit_gap']} of their max ({r})")
    spans["route_comparison"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    profile = profile_serving(torch, model, params, batch)
    spans["profile"] = time.perf_counter() - t0
    if hand_over is not None:
        hand_over.update(model=model, params=params)
    del params, engine
    if n_attn:
        del flash_logits, base_logits
    torch.cuda.empty_cache()
    return {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
            "program": [list(seg) for seg in cfg.program],
            "self_attention_layers": n_attn,
            "head_dim": cfg.head_dim, "flash": True,
            "batch": SERVE_BATCH, "prompt_len": PROMPT_LEN,
            "new_tokens": NEW_TOKENS, "init_seconds": init_s,
            "prefill_seconds": stats.prefill_seconds,
            "decode_seconds": stats.decode_seconds,
            "decode_tok_per_s": stats.decode_tps,
            "second_call": {"prefill_seconds": again.prefill_seconds,
                            "decode_tok_per_s": again.decode_tps},
            "cache_bytes": cache_bytes(model, SERVE_BATCH, max_len),
            "init_peak_memory_bytes": init_peak,
            "peak_memory_bytes": peak,
            "flash_vs_q_chunked": routes, "profile": profile,
            "span_seconds": spans,
            "first_tokens": out[:, :4].tolist(), "launches": launches}


def self_attention_layers(cfg) -> int:
    """The layers of ``cfg`` that run self-attention, the flash route's:
    every simple kind but ``ssd`` and ``xattn`` (cross-attention is plain
    attention in the reference too), composites by their sub-layers."""
    from repro_torch.models.transformer import COMPOSITE

    def per_step(kind):
        if kind in COMPOSITE:
            return sum(per_step(spec.split(":")[1])
                       for spec in COMPOSITE[kind])
        return int(kind not in ("ssd", "xattn"))
    return sum(per_step(kind) * count for kind, count in cfg.program)


@contextlib.contextmanager
def attention_inputs(on: bool):
    """While the block runs (and ``on``), every self-attention call's
    parameters, input (its block's ``ln1`` output) and options, in call
    order: a forward hook on ``models.attention.attn_forward``."""
    calls = []
    if not on:
        yield calls
        return
    from repro_torch.models import attention
    inner = attention.attn_forward

    def hook(p, x, **kw):
        calls.append((p, x, kw))
        return inner(p, x, **kw)
    attention.attn_forward = hook
    try:
        yield calls
    finally:
        attention.attn_forward = inner


def layer_attention_gaps(torch, K, calls, kernel) -> dict:
    """Each captured self-attention call run again on the same input, on
    the flash route and on the q-chunked route: max |d| / max |q-chunked|
    of its output, held to LOGIT_GAP, each flash run one launch of
    ``kernel`` and none of another flash kernel.  This holds the kernel
    at every layer of a model whose whole-model gap moves with routing
    (MoE: a routing flip between the routes changes the next layers'
    inputs)."""
    from repro_torch.models.attention import attn_forward
    gaps = []
    with torch.inference_mode():
        for p, x, kw in calls:
            before = K.launch_counts()
            got = attn_forward(p, x, **dict(kw, flash=True))
            ran = flash_deltas(before, K.launch_counts())
            if ran != {n: int(n == kernel) for n in FLASH_KERNELS}:
                raise AssertionError(f"layer {len(gaps)}: launched {ran}")
            want = attn_forward(p, x, **dict(kw, flash=False))
            gaps.append(float((got - want).abs().max()
                              / want.abs().max()))
    over = {i: g for i, g in enumerate(gaps) if not g < LOGIT_GAP}
    if not gaps or over:
        raise AssertionError(f"per-layer attention gaps over {LOGIT_GAP}: "
                             f"{over} of {len(gaps)} layers")
    return {"layers": len(gaps), "gap_max": max(gaps), "gaps": gaps,
            "bound": LOGIT_GAP}


@contextlib.contextmanager
def routing_log(cfg):
    """The experts ``models.moe._route`` picks, one (T, k) tensor a call,
    in call order, while the block runs; empty for a model without
    MoE."""
    picks = []
    if cfg.moe is None:
        yield picks
        return
    from repro_torch.models import moe
    inner = moe._route

    def spy(p, xf, dims):
        out = inner(p, xf, dims)
        picks.append(out[1])
        return out
    moe._route = spy
    try:
        yield picks
    finally:
        moe._route = inner


def routing_differences(picks, other, n_experts: int) -> dict:
    """Routing decisions (one a token and choice) of two prefills: how
    many, how many differ in place (an order swap among a token's experts
    counts), how many of a token's experts differ as a set, and the set
    differences in the first layer, before any flip cascades."""
    import torch

    def sets(t):
        return torch.zeros(t.shape[0], n_experts, dtype=torch.bool,
                           device=t.device).scatter_(1, t, True)
    per_layer = [int((sets(a) != sets(b)).sum()) // 2
                 for a, b in zip(picks, other)]
    return {"routing_decisions": sum(t.numel() for t in picks),
            "routing_decisions_differing": sum(
                int((a != b).sum()) for a, b in zip(picks, other)),
            "routing_experts_differing": sum(per_layer),
            "routing_experts_differing_first_layer": per_layer[0]}


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
    have a std of about 1, as a trained model's are of order 1-10.  A
    cross-attention's tanh gate, zero at init (the memory would reach
    nothing), is set to XATTN_GATE."""
    cfg = model.cfg
    params = model.init(generator)
    for a in _attn_params(params["segments"]):
        a["wq"].mul_(math.sqrt(cfg.n_heads / cfg.d_model))
        a["wk"].mul_(math.sqrt(cfg.n_kv / cfg.d_model))
        a["wv"].mul_(math.sqrt(cfg.n_kv / cfg.d_model))
        a["wo"].mul_(1.0 / math.sqrt(cfg.n_heads))
        if "gate" in a:
            a["gate"].fill_(XATTN_GATE)
    return params


def _attn_params(tree) -> list:
    """Every attention's parameters in ``tree``: a segment's ``attn``, or
    its sub-layers' (gemma2-2b's ``local`` and ``global``, the VLM's four
    ``self_*`` and its ``cross``)."""
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
    out = {}

    def run(name, fn):
        torch.cuda.synchronize()
        with device_profile() as prof:
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
    (causal; gemma2-2b's window of 4096 masks nothing at L 2048); and the
    sm90 route at hymba-1.5b's shape (GQA groups of 5, window 1024), where
    SDPA, which has no window, takes the window as a boolean mask, at
    hubert-xlarge's training shape (non-causal, head_dim 80: every pair
    live) and at the VLM's self layers' (64 q-heads over 8).  Then
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
        # SDPA has no window: a window shorter than L goes in as a mask
        sdpa = dict(is_causal=shp["causal"])
        if shp["window"] is not None and shp["window"] < L:
            pos = torch.arange(L, device=dev)
            d = pos[:, None] - pos[None, :]
            sdpa = dict(attn_mask=(d >= 0) & (d < shp["window"]))
        res = {"shape": {**shp, "dtype": str(dtype).split(".")[-1]},
               "flops": flops, "bytes": nbytes,
               **{key: time_ms(lambda fn=fn: fn(q, k, v, scale, *masks))
                  for key, fn in kernels.items()},
               "plain_ms": time_plain(lambda: flash_attention_ref(
                   q, k, v, scale, *masks)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   q, k, v, scale=scale, enable_gqa=True, **sdpa)),
               "library_masked": "attn_mask" in sdpa,
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
           "hymba": timed(FLASH_HYMBA, torch.bfloat16, BF16_FLOPS,
                          {"ms": flash_attention}),
           "hubert": timed(FLASH_HUBERT, torch.bfloat16, BF16_FLOPS,
                           {"ms": flash_attention}),
           "vlm": timed(FLASH_VLM, torch.bfloat16, BF16_FLOPS,
                        {"ms": flash_attention}),
           "moe_training": timed(FLASH_MOE_TRAIN, torch.bfloat16,
                                 BF16_FLOPS, {"ms": flash_attention}),
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
            for g in (1, 2, 4, 5, 8):
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
    # named; hubert-xlarge's training shape (non-causal, head_dim 80) in
    # bf16, the route its frames take
    train, gemma2, hubert = {}, {}, {}
    for shp, out, runs in ((FLASH_TRAIN, train,
                            ((torch.bfloat16, None), (torch.float32, None),
                             (torch.float32, "simt"))),
                           (FLASH_GEMMA2, gemma2,
                            ((torch.bfloat16, None), (torch.float32, None))),
                           (FLASH_HUBERT, hubert,
                            ((torch.bfloat16, None),))):
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
            "gemma2_shape": gemma2, "hubert_shape": hubert,
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

def cut_depth(cfg, steps: int):
    """``cfg`` with every segment cut to at most ``steps`` layer steps (a
    composite kind's step holds several layers): every layer kind at its
    full width, in its order.  A segment cut to one step runs as a single
    layer, without remat, as in the reference."""
    import dataclasses
    program = tuple((kind, min(count, steps)) for kind, count in cfg.program)
    return dataclasses.replace(cfg, program=program, n_layers=sum(
        cfg.layers_per_step(kind) * count for kind, count in program))


def train(torch, dev, K, arch=SERVE_ARCH, hand_over=None,
          depth=None) -> dict:
    """The training path at ``arch``'s full width under ``remat="dots"``:
    first, on the same model cut to COMPARE_DEPTH layer steps a segment
    (``cut_depth``: the kernels' shapes are the full model's), the flash
    route's gradients against the q-chunked route's (a model without
    attention, mamba2-780m, has no second route; a frames model, whose
    frames enter in bf16, compares in bf16 only) and a profile of one
    training step; then ``Trainer.run`` on the model itself with the
    launch counts of that one call.  With a ``hand_over`` dict, the
    trained params and AdamW state go into it (the checkpoint phase saves
    them) instead of being freed.  ``depth`` cuts a one-segment program
    to that many layer steps (``cut_depth``)."""
    import dataclasses
    import itertools
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticTokens
    from repro_torch.models import LM
    from repro_torch.train import OptimizerConfig, Trainer, adamw_init
    cfg = dataclasses.replace(get_config(arch), flash=True)
    if depth is not None:
        if len(cfg.program) != 1:
            raise ValueError(f"depth= cuts a one-segment program; {arch} "
                             f"has {len(cfg.program)} segments")
        cfg = cut_depth(cfg, depth)
    attention = cfg.family != "ssm"
    if cfg.remat != "dots":
        raise ValueError(f"the training run needs remat='dots', {arch} has "
                         f"{cfg.remat!r}")
    if attention and TRAIN_SEQ % cfg.flash_block:
        raise ValueError(f"the training run must take the flash route: "
                         f"{TRAIN_SEQ} tokens are no multiple of "
                         f"{arch}'s flash_block {cfg.flash_block}")
    host_batch = next(SyntheticTokens(PipelineConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab,
        seed=SEED, frontend=cfg.frontend, d_model=cfg.d_model)))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host_batch.items()}

    t0 = time.perf_counter()
    cut = LM(cut_depth(cfg, COMPARE_DEPTH))
    params = training_params(cut, torch.Generator(device=dev)
                             .manual_seed(SEED))
    dtypes = (torch.bfloat16,) if cfg.frontend == "frames" else \
        (torch.float32, torch.bfloat16)
    routes = compare_train_routes(torch, cut, params, batch, dtypes) \
        if attention else None
    profile = profile_train_step(torch, Trainer(
        cut, OptimizerConfig(**TRAIN_OPT), itertools.repeat(host_batch)),
        params, adamw_init(params), K)
    del params
    torch.cuda.empty_cache()
    cut_s = time.perf_counter() - t0

    model = LM(cfg)
    t0 = time.perf_counter()
    params = training_params(model, torch.Generator(device=dev)
                             .manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
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
    if hand_over is not None:
        hand_over.update(params=params, opt=opt)
    del params, opt, trainer
    torch.cuda.empty_cache()
    return {"arch": arch, "family": cfg.family, "layers": cfg.n_layers,
            # layers under remat: a segment of one layer runs without it,
            # as in the reference, so its forward is not recomputed
            "recomputed_layers": sum(cfg.layers_per_step(k) * c
                                     for k, c in cfg.program if c > 1),
            "head_dim": cfg.head_dim, "flash": attention,
            "remat": cfg.remat, "global_batch": TRAIN_BATCH,
            "seq_len": TRAIN_SEQ, "steps": TRAIN_STEPS,
            "optimizer": TRAIN_OPT,
            "params": model.num_params(), "init_seconds": init_s,
            "compared_layers": cut.cfg.n_layers,
            "compared_program": [list(s) for s in cut.cfg.program],
            "compare_and_profile_seconds": cut_s,
            "flash_vs_q_chunked": routes, "losses": losses,
            "grad_norms": norms, "lrs": [m["lr"] for _, m in hist],
            "step_seconds": steps, "steady_step_seconds": steady,
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / steady,
            "peak_memory_bytes": peak, "launches": launches,
            "launches_per_step": per_step, "profile": profile}


def check_training(trained: dict) -> None:
    """A training run's gates, for its arch's layer count and head dim:
    every loss and grad norm finite and positive; the last loss below the
    first.  A model without attention launches no flash kernel.  With
    attention, on the route comparison's model (``compared_layers``,
    else the run's own): f32 gradients of the flash route within
    GRAD_GAP_F32 of the q-chunked route's per leaf (per layer) and bf16
    losses within LOSS_GAP_BF16; a model compared in bf16 only (frames
    enter in bf16) has its bf16 gradients held to GRAD_GAP_BF16 instead.
    Each comparison's backward on its dtype's kernels (``flash_kernel``:
    sm90 for bf16, the head_dim-256 ones above 128; 3xTF32 for f32), one
    dq and one dkv a layer, none on any other; the f32 one's forward on
    the 3xTF32 kernel as many times as the bf16 one's sm90 forward, the
    bf16 one's on no f32 kernel.  Per step one launch a layer of the sm90
    dq and dkv kernels for this head dim, one of its sm90 forward a layer
    and one more for each layer under remat (the recompute runs its
    forward again), none on any other flash kernel (the CUDA-core ones
    included)."""
    losses, norms = trained["losses"], trained["grad_norms"]
    if not all(math.isfinite(x) and x > 0 for x in losses + norms):
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses}")
    per_step = trained["launches_per_step"]
    routes = trained["flash_vs_q_chunked"]
    if routes is None:          # no attention, so no second route
        ran = {k: per_step[k] for k in FLASH_KERNELS if per_step[k]}
        if ran:
            raise AssertionError(f"{trained['arch']} has no attention but "
                                 f"launched {ran} a step")
        return
    n, D = trained["layers"], trained["head_dim"]
    cmp_n = trained.get("compared_layers", n)
    bwd = [name for name in FLASH_KERNELS if "_dq" in name or "_dkv" in name]
    fwd = [name for name in FLASH_KERNELS if name not in bwd]
    sm90_fwd = flash_kernel("fwd", "sm90", D)
    for dtype, route in (("bfloat16", "sm90"), ("float32", "f32tc")):
        if dtype not in routes:
            continue
        got = routes[dtype]["flash_launches"]
        ran = {flash_kernel(kind, route, D) for kind in ("dq", "dkv")}
        want = {name: cmp_n * (name in ran) for name in bwd}
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"the {dtype} route comparison's backward "
                                 f"launched {got}, expected {want}")
    bf16_fwd = routes["bfloat16"]["flash_launches"]
    if not bf16_fwd[sm90_fwd] or any(bf16_fwd[k] for k in fwd
                                     if k != sm90_fwd):
        raise AssertionError(f"the bfloat16 route comparison's forward "
                             f"launched {bf16_fwd}")
    if "float32" in routes:
        got = routes["float32"]["flash_launches"]
        want = {name: 0 for name in fwd}
        want["flash_attention_f32tc"] = bf16_fwd[sm90_fwd]
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"the float32 route comparison's forward "
                                 f"launched {got}, expected {want}")
        if routes["float32"]["over_limit"]:
            raise AssertionError(f"f32 gradients of the flash route differ "
                                 f"from the q-chunked route's: "
                                 f"{routes['float32']['over_limit']}")
    elif routes["bfloat16"]["over_limit"]:
        raise AssertionError(f"bf16 gradients of the flash route differ "
                             f"from the q-chunked route's: "
                             f"{routes['bfloat16']['over_limit']}")
    if "layer_attention_grads" in routes["bfloat16"]:
        # MoE: the bf16 gate is per layer (``layer_attention_grad_gaps``,
        # which raised already); the whole-model gaps move with routing
        # flips and are reported only
        pass
    elif not routes["bfloat16"]["loss_gap"] < LOSS_GAP_BF16:
        raise AssertionError(f"bf16 losses differ: {routes['bfloat16']}")
    want = dict.fromkeys(FLASH_KERNELS, 0)
    want[sm90_fwd] = n + trained["recomputed_layers"]
    want[flash_kernel("dq", "sm90", D)] = n
    want[flash_kernel("dkv", "sm90", D)] = n
    if {k: per_step[k] for k in want} != want:
        raise AssertionError(f"launches per step {per_step}, not {want}: "
                             f"one sm90 dq and one sm90 dkv per layer and "
                             f"one sm90 forward per layer, two under remat "
                             f"(the dots recompute runs it again), none on "
                             f"any other flash kernel")


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
    if "embed" in params:           # a frames model has none
        params["embed"].mul_(1.0 / math.sqrt(model.cfg.d_model))
    return params


def compare_train_routes(torch, model, params, batch, dtypes) -> dict:
    """Loss and gradients of the flash and q-chunked routes on the same
    weights and batch, in each compute dtype of ``dtypes``, on a model
    cut to a few layers (``cut_depth``), so both routes' gradients fit on
    the card together.  A gap is max |d| / max |q-chunked| over one leaf,
    or over one layer's slice of a layer-stacked leaf (``.../wq[1]``), so
    a layer whose gradients are small is held to its own scale; the gaps
    at or over the dtype's limit (GRAD_GAP_F32, GRAD_GAP_BF16) are listed
    in ``over_limit``, which ``check_training`` gates.  Reported: the
    largest gaps, those of the embedding, the final norm and the first and
    last layers, the flash route's kernel launches, and for f32 the device
    time of the flash route's loss and gradients by kernel family
    (``torch.profiler``)."""
    import dataclasses
    import repro_torch.kernels as K
    from torch.autograd import DeviceType
    from repro_torch.models import LM
    from repro_torch.models.params import tree_leaves
    from repro_torch.train.trainer import value_and_grad
    base = LM(dataclasses.replace(model.cfg, flash=False))
    counts = [c for _, c in model.cfg.program]
    names = _leaf_names(params)
    out = {}
    moe = model.cfg.moe is not None
    for dtype in dtypes:
        f32 = dtype == torch.float32
        # MoE in bf16: the routing decisions of both routes, and each
        # layer's attention input on the q-chunked route
        spy = moe and not f32
        with compute_dtype(dtype):
            before = K.launch_counts()
            with (device_profile() if f32
                  else contextlib.nullcontext()) as prof, \
                    (routing_log(model.cfg) if spy
                     else contextlib.nullcontext()) as picks_f:
                fl, _, fg = value_and_grad(model, params, batch)
                torch.cuda.synchronize()
            after = K.launch_counts()
            fg = tree_leaves(fg)
            with (routing_log(model.cfg) if spy
                  else contextlib.nullcontext()) as picks_b, \
                    attention_inputs(spy) as calls:
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
                d = (x - y).abs().max()
                gaps[key] = float(d / y.abs().max().clamp_min(1e-30))
        del fg, bg
        torch.cuda.empty_cache()
        if f32:
            rows = [(e.key, e.self_device_time_total)
                    for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA]
            step_profile = {
                "device_ms": sum(t for _, t in rows) / 1e3,
                **{f"{tag}_ms": sum(t for k, t in rows if tag in k) / 1e3
                   for tag in ("flash_fwd", "flash_dq", "flash_dkv")}}
        # each stacked segment's first and last layer
        shown = {k: v for k, v in gaps.items()
                 if "[" not in k or k.endswith(
                     ("[0]", f"[{counts[int(k.split('/')[1])] - 1}]"))}
        limit = GRAD_GAP_F32 if f32 else GRAD_GAP_BF16
        out[str(dtype).split(".")[-1]] = r = {
            "loss_flash": float(fl), "loss_q_chunked": float(bl),
            "loss_gap": abs(float(fl) - float(bl)) / abs(float(bl)),
            "grad_gap_max": max(gaps.values()), "compared": len(gaps),
            "flash_launches": {k: after[k] - before[k] for k in after
                               if k.startswith("flash_attention")},
            "largest": dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:5]),
            "first_last_layers": shown, "limit": limit,
            "over_limit": {k: v for k, v in gaps.items()
                           if not v < limit}}
        if f32:
            r["profile"] = step_profile
        if spy:
            r.update(routing_differences(picks_f, picks_b,
                                         model.cfg.moe.n_experts))
            with compute_dtype(dtype):
                r["layer_attention_grads"] = layer_attention_grad_gaps(
                    torch, K, calls, flash_kernel("fwd", "sm90",
                                                  model.cfg.head_dim))
            del calls, picks_f, picks_b
    return out


def layer_attention_grad_gaps(torch, K, calls, kernel) -> dict:
    """The bf16 gate of a MoE model, whose whole-model gradients move with
    routing flips, at every layer on its own input (each
    captured self-attention call's ``ln1`` output): (1) the flash
    backward kernels against their plain versions on that layer's q, k, v
    and a seeded dO (``_bwd_case``: BWD_TOL, one dq and one dkv launch a
    layer); (2) the layer's attention on both routes from that input and
    one seeded cotangent: d(input) and d(wq, wk, wv, wo), each as max |d|
    / max |q-chunked|, held to GRAD_GAP_BF16 (bf16 products summed over
    the tokens, which each route rounds on its own), each flash backward
    one launch of the forward ``kernel`` and of its dq and dkv."""
    from repro_torch.models.attention import (_project_kv, _project_q,
                                              _rope_heads, attn_forward)
    gen = torch.Generator(device=calls[0][1].device).manual_seed(SEED + 9)
    D = calls[0][2]["head_dim"]
    dq, dkv = flash_kernel("dq", "sm90", D), flash_kernel("dkv", "sm90", D)
    gaps, worst, kernel_err = [], {}, []
    for i, (p, x, kw) in enumerate(calls):
        x = x.detach()
        with torch.no_grad():
            q = _project_q(p, x)
            k, v = _project_kv(p, x)
            if kw["use_rope"]:
                q, k = (_rope_heads(t, kw["positions"], kw["rope_theta"],
                                    kw["rotary_dim"]) for t in (q, k))
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        kernel_err.append(_bwd_case(torch, q, k, v, kw["causal"],
                                    kw["window"], kw["attn_cap"], gen)[:3])
        del q, k, v
        cot = torch.randn(x.shape, generator=gen, device=x.device
                          ).to(x.dtype)
        leaf = {n: p[n].detach() for n in ("wq", "wk", "wv", "wo")}
        got = {}
        for flash in (True, False):
            xs = x.clone().requires_grad_()
            ps = {n: t.clone().requires_grad_() for n, t in leaf.items()}
            before = K.launch_counts()
            with torch.enable_grad():
                y = attn_forward(dict(p, **ps), xs, **dict(kw, flash=flash))
                torch.autograd.backward(y, cot)
            ran = flash_deltas(before, K.launch_counts())
            want = {n: int(flash and n in (kernel, dq, dkv))
                    for n in FLASH_KERNELS}
            if ran != want:
                raise AssertionError(f"layer {i}: launched {ran}")
            got[flash] = {"x": xs.grad, **{n: t.grad for n, t in ps.items()}}
        layer = {n: float((got[True][n] - got[False][n]).abs().max()
                          / got[False][n].abs().max())
                 for n in got[True]}
        gaps.append(layer)
        for n, g in layer.items():
            worst[n] = max(worst.get(n, 0.0), g)
    over = {i: g for i, g in enumerate(gaps)
            if not max(g.values()) < GRAD_GAP_BF16}
    if not gaps or over:
        raise AssertionError(f"per-layer attention gradient gaps over "
                             f"{GRAD_GAP_BF16}: {over} of {len(gaps)} "
                             f"layers")
    return {"layers": len(gaps), "gap_max": max(worst.values()),
            "gap_max_by_tensor": worst, "gaps": gaps, "bound": GRAD_GAP_BF16,
            "kernel_max_abs_err": {
                n: max(e[j] for e in kernel_err)
                for j, n in enumerate(("dq", "dk", "dv"))},
            "kernel_tol": BWD_TOL["bfloat16"]}


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
    torch.cuda.synchronize()
    K.reset_launch_counts()
    with device_profile() as prof:
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
    SDPA's backward in f32.  ``hymba``: hymba-1.5b's training shape
    (``FLASH_HYMBA_TRAIN``: GQA groups of 5, head_dim 64, window 1024) on
    the sm90 kernels beside the CUDA-core ones, their bound and SDPA's
    backward with the window as a boolean mask (SDPA has no window).
    ``hubert``: hubert-xlarge's training shape (``FLASH_HUBERT``:
    non-causal, head_dim 80, 16 heads) on the sm90 kernels beside their
    bound and SDPA's non-causal backward."""
    import torch.nn.functional as F
    from repro_torch.kernels import (flash_attention, flash_attention_dkv,
                                     flash_attention_dq)
    from repro_torch.kernels.ref import (flash_attention_dkv_ref,
                                         flash_attention_dq_ref)
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def timed(res, name, flops, nbytes, peak, fns) -> None:
        r = {"flops": flops, "bytes": nbytes,
             **{key: (time_plain if key == "plain_ms" else time_ms)(fn)
                for key, fn in fns.items()},
             "bound_ms": max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3,
             "bound_by": "operations" if flops / peak >
             nbytes / HBM_BYTES_PER_S else "bytes"}
        for key in fns:
            r[f"{key}_quartiles"] = [r[key]["p25"], r[key]["p75"]]
            r[key] = r[key]["median"]
            if key != "plain_ms":
                r[key.replace("ms", "tflops")] = flops / r[key] / 1e9
        res[name] = r

    def shape(shp, dtype, peak, suffix, simt=True) -> dict:
        """Times at ``shp``, named ``flash_attention_{dq,dkv}{suffix}``;
        the CUDA-core kernels' too unless ``simt`` is false."""
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
        # SDPA has no window: a window shorter than L goes in as a mask
        mask = dict(is_causal=causal)
        if window is not None and window < L:
            pos = torch.arange(L, device=dev)
            d = pos[:, None] - pos[None, :]
            mask = dict(attn_mask=(d >= 0) & (d < window))

        def sdpa():
            return F.scaled_dot_product_attention(
                qg, kg, vg, scale=scale, enable_gqa=True, **mask)

        def sdpa_fwd_bwd():
            torch.autograd.grad(sdpa(), (qg, kg, vg), do)

        with torch.no_grad():
            fwd = device_ms(sdpa)
        library = device_ms(sdpa_fwd_bwd) - fwd
        res = {"shape": {**shp, "dtype": str(dtype).split(".")[-1]},
               "library_fwd_ms": fwd, "library_bwd_ms": library,
               "library_masked": "attn_mask" in mask}
        for kind, kernel, plain, flops, nbytes in (
                ("dq", flash_attention_dq, flash_attention_dq_ref,
                 6 * D * pairs, ins + q.numel() * size),
                ("dkv", flash_attention_dkv, flash_attention_dkv_ref,
                 8 * D * pairs, ins + 2 * per_head)):
            def simt_fn(kind=kind):
                return _bwd_kernel(torch, kind, args, "simt")
            fns = {"ms": lambda kernel=kernel: kernel(*args),
                   "plain_ms": lambda plain=plain: plain(*args)}
            if simt:
                fns["simt_ms"] = simt_fn
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
                                "_f32tc"),
            "hymba": shape(FLASH_HYMBA_TRAIN, torch.bfloat16, BF16_FLOPS, ""),
            "hubert": shape(FLASH_HUBERT, torch.bfloat16, BF16_FLOPS, "",
                            simt=False),
            "moe": shape(FLASH_MOE_TRAIN, torch.bfloat16, BF16_FLOPS, "",
                         simt=False)}


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


def _ckpt_shardings(tree):
    """Every leaf of ``tree`` split over CKPT_MESH's devices along the
    axis ``_split_axis`` picks: the flat leaves, the split axis of each
    leaf that is not a scalar, its ``MeshSharding``, and the shardings as
    a tree like ``tree``."""
    from repro_torch.checkpoint import (MeshSharding, flatten_pytree,
                                        unflatten_like)
    flat = flatten_pytree(tree)
    ids = np.arange(math.prod(CKPT_MESH)).reshape(CKPT_MESH)
    axis = {n: _split_axis(t.shape, ids.size) for n, t in flat.items()
            if t.dim()}
    sh = {n: MeshSharding(ids, CKPT_AXES, () if d is None
                          else (None,) * d + (CKPT_AXES,))
          for n, d in axis.items()}
    return flat, axis, sh, unflatten_like(tree, {n: sh.get(n) for n in flat})


def checkpoint(torch, dev, K, state: dict) -> dict:
    """The checkpoint path at full width on phase 11's trained tree (its
    params and AdamW state, popped from ``state``): ``save`` under
    ``merged_process`` from ``MeshSharding``s, the whole restore onto the
    card, an elastic restore of two leaves onto another axis, and the
    embedding alone under ``reorganized`` through the relayout kernels.
    Each step's launch counts are reset just before it and read just
    after; every check raises."""
    from repro_torch.checkpoint import (CheckpointManager,
                                        blocks_from_sharding, flatten_pytree,
                                        reshard_cost_report)
    from repro_torch.core import plan_layout, regular_decomposition
    tree = {"params": state.pop("params"), "opt_state": state.pop("opt")}
    flat, axis, sh, shardings = _ckpt_shardings(tree)
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
#: place to 2 x 8 x 4; the Fig.-6 patterns read by 4 readers (the best of
#: their 6 decompositions: 8 readers have 10, each a whole read, which
#: the run's time limit could not pay for).  The 2-D cell is slice 1's
#: component reorganized to 8 x 8
REORG_FIELD = (512, 1024, 1024)
REORG_BOX = (64, 64, 128)
REORG_SCHEMES = ((4, 4, 4), (2, 8, 4))
REORG_2D = (8, 8)
PATTERN_READERS = 4
#: the 3-D component's access history after phase 16's pattern reads,
#: exported as phase 17a's cross-run prior
STAGING_PRIOR = ROOT / "build" / "chip_smoke" / "warpx_prior.json"
#: 16d, the read service on the 3-D component: SERVICE_TENANTS tenants, one
#: thread each, each submitting these patterns' regions; in round B tenant
#: t's regions move SERVICE_SHIFT * t along axis 0, clamped to the domain.
#: Round C's regions are each tenant's SERVICE_SMALL ones, shifted as in
#: round B: a plane_yz's hull is 4 MiB under 4 x 4 x 4, a line_z's 4 KiB,
#: so they fit the in-flight limit together while a plane_xz's or a
#: plane_xy's hull (about 512 MiB) fills it alone.  The service's window is
#: its default (2 ms), the rest as below
SERVICE_TENANTS = 8
SERVICE_PATTERNS = ("sub_area", "plane_yz", "plane_xz", "plane_xy", "line_z")
SERVICE_SMALL = ("line_z", "plane_yz")
SERVICE_SHIFT = 8
SERVICE_MAX_BATCH, SERVICE_INFLIGHT = 64, 256 << 20


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
        return len(gather_batches([cp.chunk.volume * 4
                                   for cp in layout.chunks]))

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

        # 16d: the read service under both layouts, before 16c reads the
        # history (the service's sessions log nothing)
        cube["service"] = {name: serve_reads(torch, d, field, counted)
                           for name, d in (("merged_process", src),
                                           ("reorganized", dst))}

        # 16c: layout="auto" over the history the pattern reads logged;
        # the history is kept as phase 17a's prior
        AccessLog(str(src)).export_prior(str(STAGING_PRIOR))
        auto = work / "warpx_auto"
        (rs, dds, ws), secs, ran = counted(lambda: reorganize(
            str(src), str(auto), "Ez", "auto", engine="auto"))
        decision = dds.index.attrs["policy"]["Ez"]
        sizes = [r.nbytes for r in dds.index.chunks_of("Ez")]
        dds.close()
        n_batches = len(gather_batches(sizes))
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


def _shifted(region, shift: int):
    """``region`` moved ``shift`` along axis 0, clamped to the 3-D
    component."""
    from repro_torch.core.blocks import Block
    lo0 = min(region.lo[0] + shift, REORG_FIELD[0] - 1)
    hi0 = min(region.hi[0] + shift, REORG_FIELD[0])
    return Block((lo0,) + tuple(region.lo[1:]), (hi0,) + tuple(region.hi[1:]))


def serve_reads(torch, d: Path, field, counted) -> dict:
    """16d: the multi-tenant read service on one layout of the 3-D
    component.  SERVICE_TENANTS client threads each submit the five
    pattern regions (round B: each tenant's shifted; round A of earlier
    runs, the same regions for every tenant, was cut for the time limit),
    then one ``read_batch`` of round B's requests and one of
    round C's (each tenant's SERVICE_SMALL regions, shifted as in round
    B: small enough that the admission limit takes several tenants'
    members into one batch, which the check demands); every result
    ``torch.equal`` to the source on the card, every coalesced batch one
    ``pack_rows`` launch (launches == the rounds' ``super_plans``), no
    member on the host route.  After each ``read_batch``, the same
    requests as independent ``Dataset.read`` calls, for their wall
    time.  The session logs
    nothing, so 16c's history stays the pattern reads'."""
    import dataclasses
    import threading
    from repro_torch.core import pattern_region
    from repro_torch.io import Dataset
    from repro_torch.serve import ReadService, Request
    base = [pattern_region(p, REORG_FIELD) for p in SERVICE_PATTERNS]
    small = [pattern_region(p, REORG_FIELD) for p in SERVICE_SMALL]
    rounds = {"B": [[_shifted(r, SERVICE_SHIFT * t) for r in base]
                    for t in range(SERVICE_TENANTS)],
              "C": [[_shifted(r, SERVICE_SHIFT * t) for r in small]
                    for t in range(SERVICE_TENANTS)]}
    ds = Dataset.open(str(d), engine="auto", telemetry=False)
    out = {"tenants": SERVICE_TENANTS, "patterns": list(SERVICE_PATTERNS),
           "max_batch": SERVICE_MAX_BATCH,
           "max_inflight_bytes": SERVICE_INFLIGHT}

    def check(results, regions, what):
        routes = {st.route for _, st in results}
        if routes != {"device"}:
            raise AssertionError(f"{what}: members on routes {routes}")
        for (got, _), r in zip(results, regions):
            if not torch.equal(got, field[r.slices()]):
                raise AssertionError(f"{what}: {r} differs")

    def delta(before, svc):
        after = dataclasses.asdict(svc.stats)
        return {k: after[k] - before[k] for k in after}

    def tenant_seconds(before, svc):
        return {t: svc.tenant_stats(t).seconds - before.get(t, 0.0)
                for t in sorted(svc.tenants)}

    with ReadService(ds, max_batch=SERVICE_MAX_BATCH,
                     max_inflight_bytes=SERVICE_INFLIGHT,
                     engine="auto") as svc:
        for name in ("B",):
            regions = rounds[name]
            errors = []

            def tenant(t):
                try:
                    futs = [svc.submit(f"t{t}", "Ez", r)
                            for r in regions[t]]
                    check([f.result(timeout=600) for f in futs],
                          regions[t], f"round {name}, tenant {t}")
                except Exception as exc:     # noqa: BLE001 — raised below
                    errors.append(exc)

            def run():
                threads = [threading.Thread(target=tenant, args=(t,))
                           for t in range(SERVICE_TENANTS)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=900)
                    if th.is_alive():
                        raise AssertionError(f"round {name}: a tenant hung")

            before = dataclasses.asdict(svc.stats)
            t_before = {t: svc.tenant_stats(t).seconds for t in svc.tenants}
            _, secs, ran = counted(run)
            if errors:
                raise errors[0]
            st = delta(before, svc)
            if ran["pack_rows"] != st["super_plans"] or \
                    st["requests"] != SERVICE_TENANTS * len(base):
                raise AssertionError(f"round {name}: {ran} launches for "
                                     f"{st}")
            out[f"round_{name}"] = {
                "seconds": secs, "stats": st, "launches": ran,
                "fetch_bytes": st["fetch_bytes"],
                "bytes_served": st["bytes_served"],
                "tenant_seconds": tenant_seconds(t_before, svc)}
        for name, key in (("read_batch", "B"), ("read_batch_C", "C")):
            regions = [r for t in range(SERVICE_TENANTS)
                       for r in rounds[key][t]]
            reqs = [Request(f"t{t}", "Ez", r)
                    for t in range(SERVICE_TENANTS) for r in rounds[key][t]]
            before = dataclasses.asdict(svc.stats)
            res, batch_s, ran = counted(lambda: svc.read_batch(reqs))
            check(res, regions, name)
            del res
            st = delta(before, svc)
            if ran["pack_rows"] != st["super_plans"]:
                raise AssertionError(f"{name}: {ran} launches for {st}")
            # round C's regions fit the admission limit together: the
            # service must gather several tenants' members in one launch
            if key == "C" and st["super_plans"] >= st["requests"]:
                raise AssertionError(f"{name}: no batch held two members "
                                     f"({st})")

            def independent():
                for r in regions:
                    ds.read("Ez", r)

            _, ind_s, ind_ran = counted(independent)
            out[name] = {
                "requests": len(reqs), "seconds": batch_s, "stats": st,
                "launches": ran, "fetch_bytes": st["fetch_bytes"],
                "bytes_served": st["bytes_served"],
                "members_per_launch": st["requests"] / st["super_plans"],
                "independent_reads_seconds": ind_s,
                "independent_reads_launches": ind_ran}
        out["stats"] = dataclasses.asdict(svc.stats)
    ds.close()
    torch.cuda.empty_cache()
    return out


# -- phase 19 ------------------------------------------------------------------

def replay(torch, dev, K) -> dict:
    """19: every committed trace under ``traces/`` replayed by
    ``replay_trace`` with ``engine="memmap"`` on the card and on the CPU:
    one digest, the trace's own event counts, nonzero verified bytes, the
    same decisions; each card replay's copy-kernel launches (counts reset
    just before it and read just after).  The work directories lie under
    ``build/chip_smoke/replay`` and are removed."""
    from collections import Counter
    from repro_torch.io import load_trace, replay_trace
    work = ROOT / "build" / "chip_smoke" / "replay"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches = dict.fromkeys(COPY_KERNELS, 0)
    out = {"engine": "memmap", "traces": {}}
    try:
        for path in sorted((ROOT / "traces").glob("*.jsonl")):
            name = path.stem
            trace = load_trace(str(path))
            torch.cuda.synchronize()
            K.reset_launch_counts()
            t0 = time.perf_counter()
            card = replay_trace(trace, str(work / name / "card"),
                                engine="memmap", device=dev)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            ran = {k: K.launch_counts()[k] for k in COPY_KERNELS}
            t0 = time.perf_counter()
            cpu = replay_trace(trace, str(work / name / "cpu"),
                               engine="memmap", device="cpu")
            cpu_s = time.perf_counter() - t0
            want = dict(Counter(e.kind for e in trace.events))
            if card.digest != cpu.digest or card.counts != want or \
                    cpu.counts != want or card.decisions != cpu.decisions \
                    or not card.bytes_verified == cpu.bytes_verified > 0:
                raise AssertionError(
                    f"{name}: card {card.digest[:12]} {card.counts} "
                    f"{card.bytes_verified}, cpu {cpu.digest[:12]} "
                    f"{cpu.counts} {cpu.bytes_verified}, trace {want}")
            if ran["pack_rows"] <= 0:
                raise AssertionError(f"{name}: no pack_rows launch")
            for k, n in ran.items():
                launches[k] += n
            out["traces"][name] = {
                "digest": card.digest, "counts": card.counts,
                "bytes_verified": card.bytes_verified,
                "decisions": len(card.decisions), "card_seconds": card_s,
                "cpu_seconds": cpu_s, "launches": ran}
            shutil.rmtree(work / name)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if launches["chunked_to_rowmajor"] <= 0 or \
            launches["rowmajor_to_chunked"] <= 0:
        raise AssertionError(f"the replays never ran the relayout pair: "
                             f"{launches}")
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


def _direct_save(torch, params, root: Path) -> float:
    """Seconds of a synchronous ``CheckpointManager.save`` of ``params``
    as phase 15 saves its tree (``merged_process`` from the CKPT_MESH
    shardings), summed over the leaves; the directory removed after."""
    from repro_torch.checkpoint import CheckpointManager
    tree = {"params": params}
    *_, shardings = _ckpt_shardings(tree)
    mgr = CheckpointManager(str(root), keep=1, devices_per_host=CKPT_MESH[1])
    torch.cuda.synchronize()
    try:
        st = mgr.save(0, tree, shardings=shardings)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return sum(st.per_var_seconds.values())


def async_checkpoints(torch, dev, K) -> dict:
    """Async checkpoints at full width: qwen2.5-3b at ASYNC_TRAIN_DEPTH of
    its 36 layers (flash route,
    ``remat="dots"``) trained for ASYNC_SAVES steps by ``Trainer.run``
    with an ``AsyncCheckpointer`` (reorganized ASYNC_SCHEME) as its
    checkpoint manager, saving after every step; launch counts reset just
    before the run and read after the last staged write.  Every staged
    leaf is read back and held to a host copy of the params at its step
    (AdamW updates them in place in the next step).  The recommendation's
    direct write is a synchronous save of the same params, timed before
    the run (``_direct_save``)."""
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
    cfg = get_config(SERVE_ARCH)
    (kind, _), = cfg.program
    cfg = dataclasses.replace(cfg, flash=True,
                              program=((kind, ASYNC_TRAIN_DEPTH),),
                              n_layers=ASYNC_TRAIN_DEPTH)
    model = LM(cfg)
    params = training_params(model, torch.Generator(device=dev)
                             .manual_seed(SEED + 17))
    direct_s = _direct_save(torch, params, root / "direct")
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
        return {"arch": SERVE_ARCH, "layers": cfg.n_layers, "params": sum(
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


# -- phase 18 ------------------------------------------------------------------

#: 18a writes phase 16's 3-D component under each kernel-bypass engine
#: and reads each copy back whole with two engines: the O_DIRECT copy,
#: which the page cache does not hold, buffered (a cold read through the
#: cache) and direct; the io_uring copy, written buffered, through the
#: ring (hot) and the ring's direct reads (cold whatever the cache holds)
ENGINE_READS = {"odirect": ("pread", "odirect"),
                "uring": ("uring", "uring_direct")}
#: 18b: the distributed fleet, 2 worker processes on the card, 2 units
#: each, O_DIRECT writes; its lease (seconds) and the crash point one
#: worker is SIGKILLed at
FLEET_WORKERS, FLEET_UNITS, FLEET_ENGINE = 2, 2, "odirect"
FLEET_LEASE_S, FLEET_KILL_AT, FLEET_WAIT_S = 3.0, "mid_write", 120.0
#: the calibration's kernel-bypass terms
KERNEL_TERMS = ("uring_sqe_s", "uring_reg_s", "odirect_seq_read_bps",
                "odirect_seq_write_bps", "odirect_align_s")


def fleet_worker(queue, dst: str, worker: str, engine: str,
                 barrier_dir) -> None:
    """A distributed-reorganization worker process of phase 18b:
    ``worker_main`` on the card, its device warmed first and its launch
    counts reset after the warm-up; puts its stats, its ``pack_rows``
    launches, the card's name and its timeline (wall clock: entry, imports
    done, warm-up done, end) on ``queue``."""
    t_enter = time.time()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import repro_torch.kernels as K
    from repro_torch.distributed.reorg import warm_device, worker_main
    t_import = time.time()
    warm_device("cuda")
    t_warm = time.time()
    K.reset_launch_counts()
    stats = worker_main(dst, worker, engine, barrier_dir=barrier_dir,
                        device="cuda")
    torch.cuda.synchronize()
    queue.put({"worker": worker, **stats,
               "launches": {k: K.launch_counts()[k] for k in COPY_KERNELS},
               "device": torch.cuda.get_device_name(0),
               "t_enter": t_enter, "t_import": t_import, "t_warm": t_warm,
               "t_done": time.time()})


def _fleet(dst: Path, kill_at) -> dict:
    """One fleet of FLEET_WORKERS ``fleet_worker`` processes on the
    journal in ``dst``.  With ``kill_at``, only that crash point parks the
    workers, the first to reach it is SIGKILLed there and the rest are
    released: the survivors reclaim its unit once its lease expires.  Every
    wait has a deadline."""
    import multiprocessing as mp
    import os
    import signal
    from repro_torch.distributed.reorg import BARRIERS
    bdir = None
    if kill_at is not None:
        bdir = dst.parent / f"{dst.name}.barriers"
        bdir.mkdir()
        for name in BARRIERS:
            if name != kill_at:
                (bdir / f"go.{name}").touch()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    names = [f"w{i}" for i in range(FLEET_WORKERS)]
    t0 = time.time()
    procs = {w: ctx.Process(target=fleet_worker, args=(
        queue, str(dst), w, FLEET_ENGINE, bdir and str(bdir)), daemon=True)
        for w in names}
    for p in procs.values():
        p.start()
    deadline = time.monotonic() + FLEET_WAIT_S
    killed = None
    try:
        if kill_at is not None:
            while killed is None:
                reached = sorted(bdir.glob(f"*.{kill_at}.reached"))
                # a marker's pid is written just after the file appears
                pid = reached[0].read_text().strip() if reached else ""
                if pid:
                    killed = reached[0].name.split(".")[0]
                    os.kill(int(pid), signal.SIGKILL)
                    procs[killed].join(timeout=10.0)
                    t_kill = time.time() - t0
                    (bdir / f"go.{kill_at}").touch()
                elif time.monotonic() > deadline:
                    raise AssertionError(f"no worker reached {kill_at}")
                time.sleep(0.01)
        # drain the queue before joining its writers
        workers = [queue.get(timeout=max(1.0, deadline - time.monotonic()))
                   for w in names if w != killed]
        for p in procs.values():
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        if any(p.is_alive() for p in procs.values()):
            raise AssertionError("a fleet worker outlived its deadline")
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        if bdir is not None:
            shutil.rmtree(bdir, ignore_errors=True)
    wall = time.time() - t0
    for w in workers:
        w["spawn_seconds"] = w.pop("t_enter") - t0
        w["import_seconds"] = w.pop("t_import") - t0 - w["spawn_seconds"]
        w["warmup_seconds"] = w.pop("t_warm") - t0 - w["spawn_seconds"] \
            - w["import_seconds"]
        w["work_seconds"] = w.pop("t_done") - t0 - w["spawn_seconds"] \
            - w["import_seconds"] - w["warmup_seconds"]
    out = {"wall_seconds": wall, "workers": workers, "killed": killed,
           "kill_at": kill_at}
    if killed is not None:
        out["kill_seconds"] = t_kill
    return out


def _same_bytes(a: Path, b: Path) -> bool:
    if a.stat().st_size != b.stat().st_size:
        return False
    return a.stat().st_size == 0 or np.array_equal(
        np.memmap(a, dtype=np.uint8, mode="r"),
        np.memmap(b, dtype=np.uint8, mode="r"))


def _same_dataset(a: Path, b: Path) -> bool:
    """Subfiles byte-equal and ``index.json`` chunks equal."""
    bins = sorted(f.name for f in a.glob("data_*.bin"))
    if bins != sorted(f.name for f in b.glob("data_*.bin")):
        return False
    if not all(_same_bytes(a / f, b / f) for f in bins):
        return False
    return json.loads((a / "index.json").read_text())["chunks"] == \
        json.loads((b / "index.json").read_text())["chunks"]


def engines(torch, dev, K, blocks2d) -> dict:
    """The kernel-bypass engines and the distributed fleet on the card.

    18a: phase 16's 3-D component written under ``merged_process`` with
    ``engine="odirect"`` and ``engine="uring"``, and read back whole onto
    the card (``pack_rows``): the O_DIRECT copy under ``pread`` and
    ``odirect``, the io_uring copy under ``uring`` and ``uring`` with
    ``direct=True``, every read-back ``torch.equal``; slice
    1's component under ``reorganized`` 8 x 8 written and read back with
    ``odirect`` (``rowmajor_to_chunked``, ``chunked_to_rowmajor``).  Each
    transfer's engine that ran, its reason, seconds and GB/s; the uring
    pool's registration; the probes and the calibration's kernel terms.

    18b: ``distributed_reorganize`` of the component to the fixed
    ``reorganized`` 4 x 4 x 4 (phase 16's target) with O_DIRECT writes,
    2 worker processes gathering on the card: a first fleet whose first
    worker at ``mid_write`` is SIGKILLed, the survivor finishing every
    unit, then ``distributed_reorganize`` adopting the journal, validating
    and committing.  The destination held bit-identical to a
    single-process ``reorganize`` of the same source, and read back
    ``torch.equal``.  Launch counts are reset just before each step and
    read just after (in the workers for the fleet); every check raises;
    every directory is removed."""
    from repro_torch.core import (plan_layout, plan_reorganization,
                                  probe_storage, simulate_load_balance,
                                  uniform_grid_blocks)
    from repro_torch.core.blocks import Block
    from repro_torch.distributed.reorg import distributed_reorganize
    from repro_torch.io import (Dataset, ReorgJournal, build_write_plan,
                                get_engine, reorganize, resolve_engine)
    from repro_torch.io.direct import odirect_available
    from repro_torch.io.uring import uring_available
    work = ROOT / "build" / "chip_smoke" / "engines"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    launches = dict.fromkeys(COPY_KERNELS, 0)

    def counted(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        ran = {k: K.launch_counts()[k] for k in COPY_KERNELS}
        for k, n in ran.items():
            launches[k] += n
        return got, seconds, ran

    def gbps(nbytes, seconds):
        return nbytes / max(seconds, 1e-12) / 1e9

    def write_back(d, var, field, blocks, layout, engine, want):
        ds = Dataset.create(str(d), engine=engine)
        data = {b.block_id: field[b.slices()].contiguous() for b in blocks}
        ws, secs, ran = counted(lambda: ds.write(var, layout, np.float32,
                                                 data))
        ds.close()
        del data
        if any(ran[k] < n for k, n in want.items()):
            raise AssertionError(f"{d.name}: write launched {ran}")
        return {"seconds": secs, "engine_seconds": ws.write_seconds,
                "bytes": ws.bytes_written,
                "engine_gbps": gbps(ws.bytes_written, ws.write_seconds),
                "engine": ws.engine, "engine_reason": ws.engine_reason,
                "launches": ran}

    def read_back(d, var, field, name, want):
        # "uring_direct" is an engine instance resolved here, with its reason
        eng, why = resolve_engine("uring", dirpath=str(d), direct=True) \
            if name == "uring_direct" else (name, None)
        ds = Dataset.open(str(d))
        whole = Block((0,) * field.dim(), tuple(field.shape))
        (got, rs), secs, ran = counted(lambda: ds.read(var, whole,
                                                       engine=eng))
        ds.close()
        if not torch.equal(got, field):
            raise AssertionError(f"{d.name}: {name} read-back differs")
        del got
        if any(ran[k] < n for k, n in want.items()):
            raise AssertionError(f"{d.name}: {name} read-back launched {ran}")
        row = {"seconds": secs, "engine_seconds": rs.seconds,
               "bytes": rs.bytes_read,
               "engine_gbps": gbps(rs.bytes_read, rs.seconds),
               "gbps": gbps(rs.bytes_read, secs),
               "engine": rs.engine, "engine_reason": rs.engine_reason,
               "stages": {"lower": rs.lower_seconds, "h2d": rs.h2d_seconds,
                          "kernel": rs.linearize_seconds},
               "launches": ran}
        if why is not None:
            row["engine_reason"] = why or "pinned"
            row["direct"] = getattr(eng, "direct", False)
        if rs.engine.startswith("uring"):
            # the ring and whether its buffer pool is registered (fixed)
            ran_eng = get_engine(rs.engine) if isinstance(eng, str) else eng
            row["uring_ring"] = ran_eng._ring is not None
            row["uring_fixed"] = ran_eng._fixed
        return row

    out = {"uring_available": list(uring_available()),
           "odirect_available": list(odirect_available(str(work))),
           "tolerance": "bit-exact: torch.equal"}
    cal = probe_storage(str(work))
    out["calibration"] = {k: getattr(cal, k) for k in
                          ("seq_read_bps", "seq_write_bps", "memmap_bps",
                           *KERNEL_TERMS)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    try:
        # 18a: the 3-D component under each kernel-bypass write engine
        field = torch.randn(REORG_FIELD, generator=gen, device=dev)
        blocks = simulate_load_balance(
            uniform_grid_blocks(REORG_FIELD, REORG_BOX), num_procs=NPROCS,
            seed=SEED)
        merged = plan_layout("merged_process", blocks, num_procs=NPROCS,
                             procs_per_node=PPN)
        cube = {"field": list(REORG_FIELD), "chunks": len(merged.chunks),
                "writes": {}, "reads": {}}
        dirs = {e: work / f"warpx_{e}" for e in ENGINE_READS}
        for e, d in dirs.items():
            cube["writes"][e] = write_back(d, "Ez", field, blocks, merged, e,
                                           {"pack_rows": 1})
            for name in ENGINE_READS[e]:
                cube["reads"][name] = read_back(d, "Ez", field, name,
                                                {"pack_rows": 1})
        shutil.rmtree(dirs["uring"])
        out["warpx"] = cube

        # 18a: slice 1's component, reorganized 8 x 8, through O_DIRECT
        field2 = torch.randn(FIELD, generator=gen, device=dev)
        grid = plan_reorganization(blocks2d, FIELD, REORG_2D,
                                   num_stagers=NPROCS // PPN)
        d2 = work / "slice1_reorganized"
        out["slice1"] = {
            "field": list(FIELD), "scheme": list(REORG_2D),
            "write": write_back(d2, "Ez", field2, blocks2d, grid, "odirect",
                                {"rowmajor_to_chunked": 1}),
            "read": read_back(d2, "Ez", field2, "odirect",
                              {"chunked_to_rowmajor": 1})}
        del field2
        shutil.rmtree(d2)
        torch.cuda.empty_cache()

        # 18b: the fleet, held to a single-process reorganize
        src = dirs["odirect"]
        target = plan_reorganization(blocks, REORG_FIELD, REORG_SCHEMES[0],
                                     num_stagers=NPROCS // PPN)
        ref = work / "warpx_single"
        (rrs, rds, rws), ref_s, ref_ran = counted(lambda: reorganize(
            str(src), str(ref), "Ez", target, engine=FLEET_ENGINE))
        rds.close()
        fleet = {"scheme": list(REORG_SCHEMES[0]),
                 "chunks": len(target.chunks), "num_workers": FLEET_WORKERS,
                 "units": FLEET_WORKERS * FLEET_UNITS,
                 "engine": FLEET_ENGINE, "lease_s": FLEET_LEASE_S,
                 "single_process": {"seconds": ref_s, "launches": ref_ran,
                                    "stages": _reorg_stages(rrs, rws),
                                    "engine_write": rws.engine}}
        # the coordinator's journal, then a fleet of our own workers (their
        # launch counts come back over a queue), one SIGKILLed at
        # FLEET_KILL_AT: the survivor finishes every unit, reclaiming the
        # victim's once its lease expires; the coordinator, run again on
        # the destination, adopts the journal, validates and commits
        dst = work / "warpx_fleet"
        ReorgJournal.create(str(dst), build_write_plan(target, "Ez",
                                                       np.float32),
                            str(src), num_units=FLEET_WORKERS * FLEET_UNITS,
                            lease_timeout_s=FLEET_LEASE_S,
                            attrs={"var": "Ez", "engine": FLEET_ENGINE,
                                   "policy": None})
        fleet.update(_fleet(dst, FLEET_KILL_AT))
        fleet["journal_events"] = ReorgJournal(str(dst)).load()["events"]
        (dds, st), adopt_s, adopt_ran = counted(
            lambda: distributed_reorganize(
                str(src), str(dst), "Ez", target, engine=FLEET_ENGINE,
                num_workers=FLEET_WORKERS, device=dev))
        (got, _), read_s, _ = counted(lambda: dds.read(
            "Ez", Block((0, 0, 0), REORG_FIELD)))
        dds.close()
        if not torch.equal(got, field):
            raise AssertionError("fleet: read-back differs")
        del got
        t1 = time.perf_counter()
        same = _same_dataset(dst, ref)
        compare_s = time.perf_counter() - t1
        # each unit the survivors did is one gather batch at least
        gathered = sum(w["launches"]["pack_rows"] for w in fleet["workers"])
        done = sum(w["units_done"] for w in fleet["workers"])
        if not same or st["rounds"] or st["validation_failures"] or \
                done != FLEET_WORKERS * FLEET_UNITS or gathered < done:
            raise AssertionError(f"fleet: identical {same}, {st}, {done} "
                                 f"units, {gathered} launches")
        for k in COPY_KERNELS:
            launches[k] += sum(w["launches"][k] for w in fleet["workers"])
        fleet.update(adopt={"seconds": adopt_s, **st, "launches": adopt_ran},
                     read_back_seconds=read_s, compare_seconds=compare_s,
                     bit_identical_to_single_process=same)
        out["fleet"] = fleet
        del field
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    missing = [k for k in COPY_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the engines' paths never launched {missing}")
    out["launches"] = launches
    return out


# -- phase 20 ------------------------------------------------------------------

#: phase 20: the SSD and hybrid families at full width and depth, serving
#: the same traffic as phase 7 (4 prompts of 2048 tokens, 32 new tokens)
SSM_ARCH, HYBRID_ARCH = "mamba2-780m", "hymba-1.5b"
#: decode against the forward, in f32 compute: prefill DECODE_CHECK_LEN - 1
#: tokens, decode the last, held to the reference's own bound on
#: max |d| / max |ref| (``tests/test_models.py``)
DECODE_CHECK_LEN, DECODE_GAP = 256, 0.05
#: tokens decoded from the restored serving state and from the original
SNAPSHOT_DECODE = 8


def decode_check(torch, model, params, extra=None) -> dict:
    """prefill(L-1) + decode(token L) against the last position of the
    forward over all L tokens, in f32 compute, on the card; ``extra``
    joins the forward's and the prefill's batches (a VLM's memory: the
    decode step reads what the prefill cached of it)."""
    from repro_torch.models.layers import unembed_chunked
    cfg = model.cfg
    L = DECODE_CHECK_LEN
    extra = extra or {}
    toks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab, (SERVE_BATCH, L)), device=params["embed"].device)
    table = params.get("lm_head", params["embed"])
    with compute_dtype(torch.float32), torch.inference_mode():
        h, _, _ = model.hidden(params, {"tokens": toks, **extra})
        ref = unembed_chunked(h[:, -1:], table, final_cap=cfg.final_cap)
        _, cache = model.prefill(params, {"tokens": toks[:, :L - 1],
                                          **extra}, cache_len=L)
        dec, _ = model.decode_step(params, cache, toks[:, L - 1:], L - 1)
    gap = float((dec - ref).abs().max() / ref.abs().max())
    if not (torch.isfinite(dec).all() and gap < DECODE_GAP):
        raise AssertionError(f"{cfg.name}: decode differs from the forward "
                             f"by {gap} of its max logit")
    return {"tokens": L, "gap": gap, "bound": DECODE_GAP,
            "same_argmax_share": float((dec.argmax(-1) == ref.argmax(-1))
                                       .float().mean())}


def serve_ssm(torch, dev, K, arch) -> tuple:
    """20a / 20b: ``serve`` on the full ``arch`` (phase 7's traffic and
    checks; mamba2-780m has no attention, so no flash kernel may launch),
    then ``decode_check``.  Returns the phase's dict and the hand-over
    (model, params) for 20c."""
    state = {}
    out = serve(torch, dev, K, arch, hand_over=state)
    got = {n: out["launches"][n] for n in FLASH_KERNELS}
    n_attn = 0 if out["family"] == "ssm" else out["layers"]
    want = {n: n_attn * (n == flash_kernel("fwd", "sm90", out["head_dim"]))
            for n in FLASH_KERNELS}
    if got != want:
        raise AssertionError(f"{arch}: serving launched {got}, expected "
                             f"{want}")
    out["decode_check"] = decode_check(torch, state["model"],
                                       state["params"])
    return out, state


def snapshot(torch, dev, K, model, params) -> dict:
    """20c: the live serving state of ``model`` — its params and the cache
    of a prefill of phase 7's prompts (ring KV for the windowed layers,
    full KV, the f32 SSM state and the bf16 conv window) — saved by
    ``CheckpointManager`` under ``merged_process`` into
    ``build/chip_smoke/serve_snap`` and restored onto the card: every leaf
    ``torch.equal`` to its source, then SNAPSHOT_DECODE greedy tokens
    decoded from the restored state and from the original must be equal.
    The launch counts of the save and the restore; the directory
    removed."""
    from repro_torch.checkpoint import CheckpointManager, flatten_pytree
    from repro_torch.serve import cache_bytes
    cfg = model.cfg
    max_len = PROMPT_LEN + NEW_TOKENS
    prompts = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab, (SERVE_BATCH, PROMPT_LEN)), device=dev)
    with torch.inference_mode():
        logits, cache = model.prefill(params, {"tokens": prompts},
                                      cache_len=max_len)
    tree = {"params": params, "cache": cache}
    flat = flatten_pytree(tree)
    dtypes = sorted({str(t.dtype).split(".")[-1] for t in flat.values()})
    root = ROOT / "build" / "chip_smoke" / "serve_snap"
    shutil.rmtree(root, ignore_errors=True)
    launches = dict.fromkeys(COPY_KERNELS, 0)

    def counted(fn):
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        got = {k: K.launch_counts()[k] for k in COPY_KERNELS}
        for k, n in got.items():
            launches[k] += n
        return res, time.perf_counter() - t0, got

    try:
        mgr = CheckpointManager(str(root), strategy="merged_process",
                                keep=1)
        st, save_s, save_ran = counted(lambda: mgr.save(0, tree))
        (back, rs), restore_s, restore_ran = counted(
            lambda: mgr.restore(0, template=tree))
        back_flat = flatten_pytree(back)
        differ = [n for n, t in flat.items()
                  if back_flat[n].dtype != t.dtype
                  or not torch.equal(back_flat[n], t)]
        if differ:
            raise AssertionError(f"restored leaves differ: {differ[:8]}")
        stored = sum(p.stat().st_size for p in
                     Path(mgr.step_dir(0)).iterdir())

        def decode(p, c):
            cur = logits[:, -1].argmax(-1)[:, None]
            toks = []
            with torch.inference_mode():
                for i in range(SNAPSHOT_DECODE):
                    lg, c = model.decode_step(p, c, cur, PROMPT_LEN + i)
                    cur = lg[:, -1].argmax(-1)[:, None]
                    toks.append(cur)
            return torch.cat(toks, 1).cpu().numpy()

        restored_toks = decode(back["params"], back["cache"])
        original_toks = decode(params, cache)
        if not np.array_equal(restored_toks, original_toks):
            raise AssertionError(f"decode from the restored state gave "
                                 f"{restored_toks.tolist()}, from the "
                                 f"original {original_toks.tolist()}")
        if not (save_ran["pack_rows"] and restore_ran["pack_rows"]):
            raise AssertionError(f"save {save_ran}, restore {restore_ran}: "
                                 f"pack_rows never launched")
        del back, back_flat
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"arch": cfg.name, "leaves": len(flat), "dtypes": dtypes,
            "bf16_leaves": sum(t.dtype == torch.bfloat16
                               for t in flat.values()),
            "param_bytes": sum(t.numel() * t.element_size()
                               for n, t in flat.items()
                               if n.startswith("params/")),
            "cache_bytes": cache_bytes(model, SERVE_BATCH, max_len),
            "ring_slots": cfg.window,
            "save": {"seconds": save_s, "bytes": st.bytes,
                     "chunks": st.num_chunks, "stored_bytes": stored,
                     "write_seconds": st.write_seconds,
                     "commit_seconds": st.commit_seconds,
                     "launches": save_ran},
            "restore": {"seconds": restore_s, "bytes": rs.bytes_read,
                        "chunks": rs.chunks_touched,
                        "launches": restore_ran},
            "decoded_tokens": original_toks.tolist(),
            "restored_equal": True, "launches": launches}


# -- phase 22 ------------------------------------------------------------------

#: phase 22: deepseek-moe-16b at full width and depth (28 layers of 64
#: routed and 2 shared experts, 16.9e9 f32 params), phase 7's traffic.
#: Its decode check runs at capacity factor 16, as the reference's own
#: decode test does: the forward over L tokens and the prefill over L-1
#: then drop no token, so capacity drops cannot differ between them
MOE_ARCH, MOE_DECODE_CAPACITY = "deepseek-moe-16b", 16.0
#: the card's memory: phase 22's peak must stay under it
CARD_BYTES = 80 * 2 ** 30


def serve_moe(torch, dev, K) -> dict:
    """22: ``serve`` on the full deepseek-moe-16b (phase 7's traffic and
    checks, the routing decisions of each route comparison's prefills
    counted), its ``generate`` launching the sm90 forward once a layer and
    no other flash kernel, then ``decode_check`` at MOE_DECODE_CAPACITY on
    the same weights; the phase's peak device memory, the init's
    included, held under CARD_BYTES."""
    import dataclasses
    from repro_torch.models import LM
    state = {}
    out = serve(torch, dev, K, MOE_ARCH, hand_over=state)
    got = {n: out["launches"][n] for n in FLASH_KERNELS}
    want = {n: out["layers"] * (n == flash_kernel("fwd", "sm90",
                                                  out["head_dim"]))
            for n in FLASH_KERNELS}
    if got != want:
        raise AssertionError(f"{MOE_ARCH}: serving launched {got}, "
                             f"expected {want}")
    cfg = state["model"].cfg
    model = LM(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MOE_DECODE_CAPACITY)))
    out["decode_check"] = dict(decode_check(torch, model, state["params"]),
                               capacity_factor=MOE_DECODE_CAPACITY)
    out["params"] = model.num_params()
    out["phase_peak_memory_bytes"] = max(out["init_peak_memory_bytes"],
                                         torch.cuda.max_memory_allocated())
    del state
    torch.cuda.empty_cache()
    if out["phase_peak_memory_bytes"] >= CARD_BYTES:
        raise AssertionError(f"{MOE_ARCH} peaked at "
                             f"{out['phase_peak_memory_bytes']} bytes")
    return out


# -- phase 23 ------------------------------------------------------------------

#: phase 23: hubert-xlarge (48 ``enc`` layers, d_model 1280, 16 heads of
#: 80, frames in) trained at full width and depth, phase 11's traffic in
#: frames; then one prefill over phase 7's batch of frames
ENCODER_ARCH = "hubert-xlarge"


def encoder(torch, dev, K) -> dict:
    """23: ``train`` on the full hubert-xlarge (its frames enter in bf16,
    so its route comparison runs once, in bf16, on the sm90 kernels) and
    ``check_training``; then one ``LM.prefill`` over SERVE_BATCH x
    PROMPT_LEN frames of the pipeline on the trained weights, timed, with
    its launches (one sm90 forward a layer, none other), and the flash
    route's logits at every frame against the q-chunked route's, held to
    LOGIT_GAP."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticTokens
    from repro_torch.models import LM
    from repro_torch.models.layers import unembed_chunked
    state = {}
    out = train(torch, dev, K, ENCODER_ARCH, hand_over=state)
    check_training(out)
    del state["opt"]
    params = state.pop("params")
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(ENCODER_ARCH), flash=True)
    model = LM(cfg)
    base = LM(dataclasses.replace(cfg, flash=False))
    frames = next(SyntheticTokens(PipelineConfig(
        global_batch=SERVE_BATCH, seq_len=PROMPT_LEN, vocab=cfg.vocab,
        seed=SEED, frontend="frames", d_model=cfg.d_model)))["frames"]
    batch = {"frames": torch.as_tensor(frames, device=dev)}
    with torch.inference_mode():
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = {n: K.launch_counts()[n] for n in FLASH_KERNELS}
        want = {n: cfg.n_layers * (n == flash_kernel("fwd", "sm90",
                                                     cfg.head_dim))
                for n in FLASH_KERNELS}
        if launches != want or cache != [None] or \
                logits.shape != (SERVE_BATCH, 1, cfg.vocab) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"hubert-xlarge prefill: launches "
                                 f"{launches} (expected {want}), cache "
                                 f"{cache}, logits {tuple(logits.shape)}")
        every = [unembed_chunked(m.hidden(params, batch)[0],
                                 params["lm_head"])
                 for m in (model, base)]
    gap = float((every[0] - every[1]).abs().max() / every[1].abs().max())
    if not gap < LOGIT_GAP:
        raise AssertionError(f"hubert-xlarge: the flash route's logits "
                             f"differ from the q-chunked route's by {gap}")
    out["prefill"] = {"batch": SERVE_BATCH, "frames": PROMPT_LEN,
                      "seconds": prefill_s, "launches": launches,
                      "dtype": str(every[0].dtype), "logit_gap": gap,
                      "same_argmax_share": float(
                          (every[0].argmax(-1) == every[1].argmax(-1))
                          .float().mean())}
    del params, every, logits
    torch.cuda.empty_cache()
    return out


# -- phase 24 ------------------------------------------------------------------

#: phase 24: llama-3.2-vision-90b at full width and one of its 20
#: ``group_sx`` steps (4 self layers and 1 cross layer: the whole model's
#: 360 GB of f32 params does not fit a card), phase 7's traffic with
#: memory tokens of 0.02·N(0, 1) in bf16, as its serve launcher draws them
VLM_ARCH, VLM_DEPTH, VLM_MEMORY_STD = "llama-3.2-vision-90b", 1, 0.02
#: every cross-attention gate of the served weights: tanh(1) = 0.76 of the
#: cross layer's output reaches the residual (the init's zero would hide
#: the memory)
XATTN_GATE = 1.0


def serve_vlm(torch, dev, K) -> dict:
    """24: ``serve`` on llama-3.2-vision-90b at VLM_DEPTH (its bf16 prefill
    launching the sm90 forward once a self layer, none other: the cross
    layer is plain attention), the memory tokens through
    ``generate(extra=)``; every gate at XATTN_GATE; then ``decode_check``
    with the same memory, and the phase's peak device memory, the init's
    included, held under CARD_BYTES."""
    from repro_torch.configs import get_config
    cfg = get_config(VLM_ARCH)
    memory = (VLM_MEMORY_STD * torch.randn(
        (SERVE_BATCH, cfg.n_memory_tokens, cfg.d_model),
        generator=torch.Generator(device=dev).manual_seed(SEED + 7),
        device=dev)).to(torch.bfloat16)
    state = {}
    out = serve(torch, dev, K, VLM_ARCH, hand_over=state, depth=VLM_DEPTH,
                extra={"memory": memory})
    n_self = out["self_attention_layers"]
    got = {n: out["launches"][n] for n in FLASH_KERNELS}
    want = {n: n_self * (n == flash_kernel("fwd", "sm90", out["head_dim"]))
            for n in FLASH_KERNELS}
    if n_self != 4 * VLM_DEPTH or got != want:
        raise AssertionError(f"{VLM_ARCH}: serving launched {got}, "
                             f"expected {want}")
    gates = state["params"]["segments"][0]["cross"]["attn"]["gate"]
    gates = gates.reshape(-1).tolist()
    if gates != [XATTN_GATE] * VLM_DEPTH:
        raise AssertionError(f"cross-attention gates {gates}")
    out["gates"] = gates
    out["memory"] = {"shape": list(memory.shape), "dtype": "bfloat16",
                     "std": VLM_MEMORY_STD}
    out["decode_check"] = decode_check(torch, state["model"],
                                       state["params"], {"memory": memory})
    out["params"] = state["model"].num_params()
    out["phase_peak_memory_bytes"] = max(out["init_peak_memory_bytes"],
                                         torch.cuda.max_memory_allocated())
    del state, memory
    torch.cuda.empty_cache()
    if out["phase_peak_memory_bytes"] >= CARD_BYTES:
        raise AssertionError(f"{VLM_ARCH} peaked at "
                             f"{out['phase_peak_memory_bytes']} bytes")
    return out


# -- phase 25 ------------------------------------------------------------------

#: phase 25 trains deepseek-moe-16b at full width and 4 of its 28 ``moe``
#: layers (2.77e9 f32 params; with grads and AdamW's m and v about 44 GB)
MOE_TRAIN_DEPTH = 4


def train_moe(torch, dev, K) -> dict:
    """25: ``train`` on deepseek-moe-16b cut to MOE_TRAIN_DEPTH layers
    (phase 11's traffic), then ``check_training``: the f32 route
    comparison gated whole (GRAD_GAP_F32 per leaf), the bf16 one per layer
    (``layer_attention_grad_gaps``) with the whole-model gaps and the
    routing decisions that differ reported; the phase's peak device
    memory under CARD_BYTES."""
    torch.cuda.reset_peak_memory_stats()
    out = train(torch, dev, K, MOE_ARCH, depth=MOE_TRAIN_DEPTH)
    out["phase_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    check_training(out)
    if "layer_attention_grads" not in out["flash_vs_q_chunked"]["bfloat16"]:
        raise AssertionError("the MoE bf16 comparison ran no per-layer "
                             "attention gate")
    if out["phase_peak_memory_bytes"] >= CARD_BYTES:
        raise AssertionError(f"{MOE_ARCH} training peaked at "
                             f"{out['phase_peak_memory_bytes']} bytes")
    return out


# -- phase 26 ------------------------------------------------------------------

#: phase 26: a world of DIST_WORLD ranks on the one card (gloo: NCCL
#: refuses two ranks on one device), each a spawned process on cuda:0
DIST_WORLD, DIST_WAIT_S = 2, 600.0
#: (a) deepseek-moe-16b at full width on mesh (data 1, model 2) at
#: DIST_DEPTH_A layer steps, local dispatch, f32; (b) on mesh (data 2,
#: model 1) at DIST_DEPTH_B, ``make_train_step_reduce_once`` with
#: DIST_ACCUM microbatches of one row on each data rank
DIST_DEPTH_A, DIST_DEPTH_B, DIST_ACCUM = 2, 1, 2
#: gates: the loss (relative) and each gradient leaf (max |d| / max |oracle|)
DIST_LOSS_GAP, DIST_GRAD_GAP = 1e-5, 1e-4
#: the card's memory in use by all the phase's processes
DIST_MEM_BYTES = 75e9
#: the collectives the probe tries on CUDA tensors over gloo
DIST_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "all_to_all_single", "broadcast")


def _probe_collectives(torch, dist, dev) -> dict:
    """Which collectives gloo takes on CUDA tensors: each tried once on a
    small tensor, its result checked; the error where it refuses."""
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {}
    x = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank
    want = {"all_reduce": (x.cpu() * 0 + sum(
        torch.arange(4 * world, dtype=torch.float32) + r
        for r in range(world)))}
    for name in DIST_COLLECTIVES:
        try:
            if name == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok = torch.equal(y.cpu(), want["all_reduce"])
            elif name == "all_gather_into_tensor":
                y = torch.empty(x.numel() * world, device=dev)
                dist.all_gather_into_tensor(y, x)
                ok = torch.equal(y[rank * x.numel():(rank + 1) * x.numel()],
                                 x)
            elif name == "reduce_scatter_tensor":
                y = torch.empty(x.numel() // world, device=dev)
                dist.reduce_scatter_tensor(y, x)
                n = x.numel() // world
                ok = torch.equal(y.cpu(), want["all_reduce"][
                    rank * n:(rank + 1) * n])
            elif name == "all_to_all_single":
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x)
                n = x.numel() // world
                ok = torch.equal(y[:n].cpu(), (torch.arange(
                    rank * n, (rank + 1) * n, dtype=torch.float32)))
            else:
                y = x.clone()
                dist.broadcast(y, 0)
                ok = torch.equal(y.cpu(), (torch.arange(
                    4 * world, dtype=torch.float32)))
            out[name] = "ok" if ok else "wrong result"
        except Exception as e:              # noqa: BLE001 - the probe's answer
            out[name] = f"{type(e).__name__}: {str(e)[:200]}"
    return out


def _leaf_gaps(got: dict, want: dict) -> dict:
    """max |got - want| / max |want| of each leaf."""
    return {n: float((got[n] - want[n]).abs().max()
                     / want[n].abs().max().clamp_min(1e-30)) for n in want}


def _sharded_flash_bf16(torch, dev, K, mesh, rank: int, shape) -> dict:
    """26a in bf16: ``_flash_sharded`` forward and backward on seeded bf16
    q, k, v, dO of ``shape`` (B, H, L, D), causal, placed by DEFAULT_RULES
    on ``mesh`` (the heads split over ``"model"``: the sm90 kernels run on
    each rank's H / 2 heads), launches counted around it; then the
    unsharded kernels on the same whole tensors, uncounted, and each
    leaf's gap on this rank's block (max |d| / max |unsharded|)."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.checkpoint.blocks_map import (MeshDevice,
                                                   dtensor_sharding)
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.attention import _flash_sharded
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v, do = (torch.randn(shape, generator=gen, device=dev,
                               dtype=torch.bfloat16) for _ in range(4))
    scale = shape[-1] ** -0.5
    with shd.use_sharding(mesh, shd.DEFAULT_RULES) as ctx:
        pl = ctx.placements(("batch", "act_heads", None, None), shape)
        tq, tk, tv = (distribute_tensor(t, mesh, pl, src_data_rank=None)
                      .requires_grad_() for t in (q, k, v))
        tdo = distribute_tensor(do, mesh, pl, src_data_rank=None)
        _sync(torch, dev)
        K.reset_launch_counts()
        with shd.replicate_plain():
            o = _flash_sharded(tq, tk, tv, scale, True, None, None, 256)
            o.backward(tdo)
        _sync(torch, dev)
        launches = K.launch_counts()
    idx = dtensor_sharding(o).devices_indices_map(shape)[MeshDevice(rank)]
    got = {"o": o.to_local(), "dq": tq.grad.to_local(),
           "dk": tk.grad.to_local(), "dv": tv.grad.to_local()}
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    whole = flash_attention(q, k, v, scale, True, None, None, 256, 256)
    whole.backward(do)
    want = {"o": whole.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    gaps = _leaf_gaps({n: t.float() for n, t in got.items()},
                      {n: t[idx].float() for n, t in want.items()})
    return {"shape": list(shape), "local_heads": got["o"].shape[1],
            "launches": launches, "gaps": gaps,
            "bit_equal": all(torch.equal(got[n], want[n][idx])
                             for n in got)}


#: 26a's bf16 step against the unsharded bf16 step: the loss (relative)
DIST_LOSS_GAP_BF16 = 1e-2


@contextlib.contextmanager
def attention_input_grads():
    """While the block runs, the gradient of every self-attention call's
    input (its block's ``ln1`` output), in forward call order: a hook on
    each input ``models.attention.attn_forward`` takes in the forward
    pass (a remat recompute inside the backward adds none)."""
    import torch
    from repro_torch.models import attention
    inner = attention.attn_forward
    grads = []

    def spy(p, x, **kw):
        if x.requires_grad and torch._C._current_graph_task_id() == -1:
            i = len(grads)
            grads.append(None)

            def keep(g, i=i):
                grads[i] = g.detach().clone()
            x.register_hook(keep)
        return inner(p, x, **kw)
    attention.attn_forward = spy
    try:
        yield grads
    finally:
        attention.attn_forward = inner


def _sharded_step_bf16(torch, dev, K, model, mesh, rank: int, batch,
                       opt_cfg) -> dict:
    """26a in bf16: one ``make_train_step`` on ``mesh`` under the config's
    remat (launch counts reset just before it), held to the unsharded
    bf16 step on the same seeded params, which rank 0 runs first, as phase
    25 holds its routes: the loss within DIST_LOSS_GAP_BF16 (relative);
    each layer's attention input gradient and each layer's attention
    weights' first moments ((1 - b1) x the clipped gradient) within
    GRAD_GAP_BF16 of their max; the routing decisions that differ
    reported, not gated."""
    import torch.distributed as dist
    from repro_torch.checkpoint.blocks_map import flatten_pytree
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import adamw_init, make_train_step
    from repro_torch.train.trainer import place_batch
    step = make_train_step(model, opt_cfg)
    attn = [n for n in flatten_pytree(model.skeleton())
            if "/attn/w" in n]

    def run(sharded: bool):
        with compute_dtype(torch.bfloat16), \
                routing_log(model.cfg) as picks, \
                attention_input_grads() as xg, \
                (shd.use_sharding(mesh, shd.DEFAULT_RULES) if sharded
                 else contextlib.nullcontext()):
            params = training_params(model, torch.Generator(device=dev)
                                     .manual_seed(SEED))
            opt = adamw_init(params)
            _sync(torch, dev)
            K.reset_launch_counts()
            t0 = time.perf_counter()
            _, opt, metrics = step(params, opt, place_batch(batch)
                                   if sharded else batch)
            _sync(torch, dev)
            seconds = time.perf_counter() - t0
            launches = K.launch_counts()
        m = flatten_pytree(opt["m"])

        def whole(t):
            return t.full_tensor() if shd.is_dtensor(t) else t
        out = {"loss": float(whole(metrics["loss"])), "seconds": seconds,
               "launches": launches, "picks": picks,
               "m": {n: whole(m[n]) for n in attn},
               "x": [whole(g) for g in xg]}
        del params, opt, metrics, m
        return out
    want = run(False) if rank == 0 else None
    _sync(torch, dev)
    dist.barrier()
    got = run(True)
    res = {"remat": model.cfg.remat, "seconds": got["seconds"],
           "launches": got["launches"], "layers": len(got["x"])}
    if rank == 0:
        counts = {n: model.cfg.program[int(n.split("/")[1])][1]
                  for n in attn}
        gaps = {}
        for n in attn:
            a, b = got["m"][n], want["m"][n]
            for i in range(counts[n]) if counts[n] > 1 else [None]:
                x, y = (a, b) if i is None else (a[i], b[i])
                gaps[n if i is None else f"{n}[{i}]"] = float(
                    (x - y).abs().max() / y.abs().max().clamp_min(1e-30))
        for i, (x, y) in enumerate(zip(got["x"], want["x"])):
            gaps[f"attention_input[{i}]"] = float(
                (x.float() - y.float()).abs().max()
                / y.float().abs().max().clamp_min(1e-30))
        res.update(
            oracle_loss=want["loss"], loss=got["loss"],
            loss_gap=abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            oracle_layers=len(want["x"]), grad_gap_max=max(gaps.values()),
            grad_gaps=gaps, bound=GRAD_GAP_BF16,
            **routing_differences(got["picks"], want["picks"],
                                  model.cfg.moe.n_experts))
    del got, want
    return res


def _mem_used(torch, dev) -> int:
    """The card's memory in use by every process (``mem_get_info``; 0 on
    the CPU)."""
    if dev.type != "cuda":
        return 0
    free, total = torch.cuda.mem_get_info()
    return total - free


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# DTensor's collectives through the classic c10d calls: the harness's
# two ranks share one card, so their world is gloo over CUDA tensors

def _classic_ops(dist):
    return {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.AVG,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
            "product": dist.ReduceOp.PRODUCT}


def _classic_group(group_name: str):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name)


#: the functional collectives the classic kernels ran, in the forward
#: and the backward (counted while ``classic_dtensor_collectives`` is on)
CLASSIC_COUNTS = {"forward": 0, "backward": 0}


def _counted(fn):
    def run(*args):
        import torch
        CLASSIC_COUNTS["backward" if torch._C._current_graph_task_id() != -1
                       else "forward"] += 1
        return fn(*args)
    return run


def _classic_all_reduce(input, reduce_op, group_name):
    import torch
    import torch.distributed as dist
    out = input.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_classic_ops(dist)[reduce_op.lower()],
                    group=_classic_group(group_name))
    return out


def _classic_all_gather(input, group_size, group_name):
    import torch.distributed as dist
    x = input.contiguous()
    out = x.new_empty((x.shape[0] * group_size,) + tuple(x.shape[1:]))
    dist.all_gather(list(out.chunk(group_size)), x,
                    group=_classic_group(group_name))
    return out


def _classic_reduce_scatter(input, reduce_op, group_size, group_name):
    import torch.distributed as dist
    x = input.contiguous()
    out = x.new_empty((x.shape[0] // group_size,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=_classic_ops(dist)[
        reduce_op.lower()], group=_classic_group(group_name))
    return out


def _classic_all_to_all_single(input, output_split_sizes, input_split_sizes,
                               group_name):
    import torch.distributed as dist
    x = input.contiguous()
    rows = sum(output_split_sizes) if output_split_sizes else x.shape[0]
    out = x.new_empty((rows,) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes or None,
                           input_split_sizes or None,
                           group=_classic_group(group_name))
    return out


def _classic_wait(tensor):
    return tensor           # the classic call had finished


def _classic_shard_dim_alltoall(input, gather_dim, shard_dim, mesh,
                                mesh_dim):
    # as DTensor does it on the CPU: the gather, then this rank's block
    from torch.distributed import _functional_collectives as funcol
    out = funcol.all_gather_tensor(input.contiguous(), gather_dim,
                                   (mesh, mesh_dim))
    return out.chunk(mesh.size(mesh_dim), dim=shard_dim)[
        mesh.get_local_rank(mesh_dim)].contiguous()


@contextlib.contextmanager
def classic_dtensor_collectives(device_type: str = "cuda"):
    """The functional collectives (the ``_c10d_functional`` ops that
    DTensor's redistributions and the port's layer sums run) as the
    classic, synchronous c10d calls (``all_reduce``, ``all_gather`` of a
    list, ``reduce_scatter_tensor``, ``all_to_all_single``) on
    ``device_type`` tensors for the duration of the block: their
    ``device_type`` kernels are replaced, ``wait_tensor`` is the identity,
    and DTensor's ``shard_dim_alltoall`` gathers then slices.  On torch
    2.11 the functional collectives segfault on CUDA tensors over gloo (in
    their ``wait_tensor``), the backend of phase 26's two ranks on one
    card; the classic calls work there.  The ops stay what autograd and a
    remat policy see, so a policy that keeps their outputs keeps them
    here too.  Each run is counted in CLASSIC_COUNTS.  No collective
    leaves the tensors' device."""
    import torch
    from torch.distributed.tensor import _collective_utils as cu
    lib = torch.library.Library("_c10d_functional", "IMPL")
    key = {"cuda": "CUDA", "cpu": "CPU"}[device_type]
    for name, fn in (("all_reduce", _classic_all_reduce),
                     ("all_gather_into_tensor", _classic_all_gather),
                     ("reduce_scatter_tensor", _classic_reduce_scatter),
                     ("all_to_all_single", _classic_all_to_all_single)):
        lib.impl(name, _counted(fn), key)
    lib.impl("wait_tensor", _classic_wait, key)
    saved = []
    original = cu.shard_dim_alltoall
    for mod in list(sys.modules.values()):       # imported by name too
        if getattr(mod, "__name__", "").startswith("torch.distributed") \
                and getattr(mod, "shard_dim_alltoall", None) is original:
            saved.append((mod, "shard_dim_alltoall", original))
            setattr(mod, "shard_dim_alltoall", _classic_shard_dim_alltoall)
    try:
        yield CLASSIC_COUNTS
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)
        lib._destroy()


def dist_worker(rank: int, queue, go, init: str, ckpt_root: str,
                device: str = "cuda", smoke: bool = False) -> None:
    """A rank of phase 26's world: gloo over CUDA tensors on cuda:0.
    (a) deepseek-moe-16b cut to DIST_DEPTH_A, ``dispatch="local"``, f32:
    first the oracle, the step's gradients without a mesh, on each rank at
    once, made into the first AdamW step's first moments (0.1 x the
    clipped gradient); then the seeded params placed by DEFAULT_RULES on
    mesh (data 1, model 2) and the same step (launch counts reset just
    before it), each rank's blocks of the first moments held to the
    oracle's (the maxima over the ranks: the whole leaf's gap); then
    ``_sharded_flash_bf16`` on the same mesh.  (c)
    ``CheckpointManager.save`` of the stepped sharded params under
    ``merged_process`` (rank 0 writes), then ``restore`` onto the params'
    placements (each rank reads its own blocks), every leaf's block
    ``torch.equal`` to the rank's own.  (b) the model cut to DIST_DEPTH_B
    on mesh (data 2, model 1): ``make_train_step_reduce_once``'s reduced
    gradients over DIST_ACCUM microbatches of each rank's rows;
    ``compressed_psum_tree`` on the attention and router gradients, on
    the card and on CPU copies through the same gloo world, bit-equal;
    ``reduce_scatter_then_gather`` of one leaf against its all_reduce;
    rank 0's oracle, the same 4 rows one a microbatch without a mesh on
    its own replica; then AdamW on each replica.
    The rank imports and joins the world at once, then waits for ``go``
    (an event the parent sets when the card is free) before it touches
    the card.  Puts its results on ``queue``; any exception is put there
    too and ends the rank with exit code 1.  With ``smoke`` (and
    ``device="cpu"`` where there is no card) the same at the smoke
    config's width and a batch of 64 tokens a row:
    ``tests/test_torch_cuda.py`` runs it so on the card."""
    import faulthandler
    import os
    t_enter = time.time()
    # each stage as it starts, on a file of the rank's own: the parent
    # shows the last ones of a rank that died without a report
    trail = open(Path(ckpt_root).parent / f"rank{rank}.trail", "w")
    faulthandler.enable(trail)

    def mark(stage: str) -> None:
        mark.stages.append((stage, time.time() - t_enter))
        trail.write(f"{mark.stages[-1][1]:.3f} {stage}\n")
        trail.flush()
    mark.stages = []
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    try:
        with classic_dtensor_collectives():
            res = _dist_world(rank, go, init, ckpt_root, device, smoke,
                              mark, t_enter)
        queue.put(res)
        dist.destroy_process_group()
    except BaseException as e:               # noqa: BLE001 - reported
        import traceback
        queue.put({"rank": rank, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]})
        queue.close()
        queue.join_thread()         # the message out before the exit
        os._exit(1)


def _dist_world(rank, go, init, ckpt_root, device, smoke, mark, t_enter):
    """``dist_worker``'s body (DTensor's collectives on the classic c10d
    calls: ``classic_dtensor_collectives``)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    import repro_torch.kernels as K
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import PipelineConfig, SyntheticTokens
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import (
        compressed_psum_tree, reduce_scatter_then_gather)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.models.params import shardings
    from repro_torch.train import (OptimizerConfig, adamw_init,
                                   global_norm, make_train_step,
                                   make_train_step_reduce_once)
    from repro_torch.train.trainer import place_batch, value_and_grad
    from repro_torch.checkpoint.blocks_map import (MeshDevice,
                                                   blocks_from_sharding,
                                                   dtensor_sharding,
                                                   flatten_pytree)
    from repro_torch.configs import get_smoke_config
    dev = torch.device(device, 0) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    seq = 64 if smoke else TRAIN_SEQ
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=DIST_WORLD)
    # both meshes (their process groups) while the earlier phases run
    tp_mesh = make_mesh((1, DIST_WORLD), ("data", "model"), dev.type)
    dp_mesh = make_mesh((DIST_WORLD, 1), ("data", "model"), dev.type)
    t_import = time.time()
    mark("joined")
    if not go.wait(DIST_WAIT_S):
        raise TimeoutError("the parent never freed the card")
    t_go = time.time()
    mark("probe")
    res = {"rank": rank, "collectives": _probe_collectives(
        torch, dist, dev)}
    mem = [_mem_used(torch, dev)]
    base = dataclasses.replace((get_smoke_config if smoke else
                                get_config)(MOE_ARCH), flash=True)
    if smoke:       # the full config's remat and loss chunking
        base = dataclasses.replace(base, remat="dots", loss_chunk=32,
                                   flash_block=32)
    opt_cfg = OptimizerConfig(**TRAIN_OPT)

    def host_batch(rows):
        b = next(SyntheticTokens(PipelineConfig(
            global_batch=rows, seq_len=seq, vocab=base.vocab,
            seed=SEED, frontend=base.frontend, d_model=base.d_model)))
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    def free():
        _sync(torch, dev)
        mem.append(_mem_used(torch, dev))

    mark("a: init")
    # (a) tensor and expert parallel: mesh (data 1, model 2), under the
    # config's own remat="dots"
    cfg = cut_depth(dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch="local")), DIST_DEPTH_A)
    model = LM(cfg, device=dev)
    batch = host_batch(TRAIN_BATCH)
    # the oracle first, on each rank at once: the same gradients without
    # a mesh, made into the first AdamW step's first moments as
    # ``adamw_update`` makes them ((1 - b1) x the clipped gradient); each
    # rank holds its own blocks to them, so no gradient crosses ranks
    t0 = time.perf_counter()
    with compute_dtype(torch.float32):
        params = training_params(model, torch.Generator(device=dev)
                                 .manual_seed(SEED))
        ref_loss, _, grads = value_and_grad(model, params, batch)
        mem.append(_mem_used(torch, dev))
    del params
    with torch.no_grad():
        gn = global_norm(grads)
        clip = torch.clamp(opt_cfg.grad_clip / (gn + 1e-9), max=1.0)
        oracle_m = {n: g.mul_(clip).mul_(1 - opt_cfg.b1)
                    for n, g in flatten_pytree(grads).items()}
    ref_loss = float(ref_loss)
    del grads
    free()
    oracle_s = time.perf_counter() - t0
    mark("a: init")
    t0 = time.perf_counter()
    mesh = tp_mesh
    with compute_dtype(torch.float32), \
            shd.use_sharding(mesh, shd.DEFAULT_RULES):
        params = training_params(model, torch.Generator(device=dev)
                                 .manual_seed(SEED))
        opt = adamw_init(params)
        mem.append(_mem_used(torch, dev))
        mark("a: step")
        step = make_train_step(model, opt_cfg)
        _sync(torch, dev)
        K.reset_launch_counts()
        t1 = time.perf_counter()
        params, opt, metrics = step(params, opt, place_batch(batch))
        _sync(torch, dev)
        step_s = time.perf_counter() - t1
        launches = K.launch_counts()
        mem.append(_mem_used(torch, dev))
        mark("a: compare")
        loss = float(metrics["loss"].to_local())
        # max |d| and max |oracle| of each leaf over this rank's block,
        # then the maxima over the ranks: the whole leaf's gap
        names = list(oracle_m)
        stats = torch.zeros(len(names), 2, dtype=torch.float64,
                            device=dev)
        for i, (n, t) in enumerate(flatten_pytree(opt["m"]).items()):
            idx = dtensor_sharding(t).devices_indices_map(t.shape)[
                MeshDevice(rank)]
            want = oracle_m[n][idx]
            stats[i, 0] = (t.to_local() - want).abs().max()
            stats[i, 1] = want.abs().max()
        dist.all_reduce(stats, op=dist.ReduceOp.MAX)
        gaps = dict(zip(names, (stats[:, 0] / stats[:, 1].clamp_min(
            1e-30)).tolist()))
        del oracle_m
        local_params = sum(t.to_local().numel() for t in
                           flatten_pytree(params).values())
        spec_blocks = sum(len(blocks_from_sharding(d.shape, sh))
                          for d, sh in zip(
                              flatten_pytree(model.skeleton()).values(),
                              flatten_pytree(shardings(
                                  model.skeleton())).values())
                          if len(d.shape))
    res["a"] = {"mesh": [1, DIST_WORLD], "layers": cfg.n_layers,
                "head_dim": cfg.head_dim, "remat": cfg.remat,
                "params": model.num_params(),
                "local_params": local_params, "loss": loss,
                "step_seconds": step_s,
                "setup_seconds": t1 - t0,
                "launches": launches, "oracle_loss": ref_loss,
                "loss_gap": abs(loss - ref_loss) / abs(ref_loss),
                "grad_gap_max": max(gaps.values()),
                "grad_gaps_largest": dict(sorted(
                    gaps.items(), key=lambda kv: -kv[1])[:6]),
                "leaves": len(gaps), "oracle_seconds": oracle_s}
    mark("a: bf16 flash")
    res["a"]["bf16_flash"] = _sharded_flash_bf16(
        torch, dev, K, tp_mesh, rank,
        (TRAIN_BATCH, cfg.n_heads, seq, cfg.head_dim))
    mark("c: save")
    # (c) the sharded params through the checkpoint
    t0 = time.perf_counter()
    K.reset_launch_counts()
    mgr = CheckpointManager(ckpt_root, strategy="merged_process",
                            device=dev)
    stats = mgr.save(0, params)
    save_launches = K.launch_counts()["pack_rows"]
    t1 = time.perf_counter()
    K.reset_launch_counts()
    got, _ = mgr.restore(0, template=params)     # each rank its blocks
    restore_launches = K.launch_counts()["pack_rows"]
    restore_s = time.perf_counter() - t1
    equal = all(torch.equal(g.to_local(), t.to_local())
                and g.placements == t.placements
                for g, t in zip(flatten_pytree(got).values(),
                                flatten_pytree(params).values()))
    del got
    dist.barrier()
    if rank == 0:
        shutil.rmtree(ckpt_root, ignore_errors=True)
    res["c"] = {"saved_bytes": stats.bytes,
                "blocks": stats.num_original_blocks,
                "mesh_sharding_blocks": spec_blocks,
                "chunks": stats.num_chunks,
                "save_seconds": stats.seconds,
                "restore_seconds": restore_s,
                "pack_rows_save": save_launches,
                "pack_rows_restore": restore_launches,
                "restored_equal": equal,
                "seconds": time.perf_counter() - t0}
    del params, opt, metrics, step
    dist.barrier()
    free()
    mark("a: bf16 step")
    res["a"]["bf16_step"] = _sharded_step_bf16(
        torch, dev, K, model, tp_mesh, rank, batch, opt_cfg)
    dist.barrier()
    free()

    mark("b: init")
    # (b) data parallel, reduce once: mesh (data 2, model 1)
    cfg = cut_depth(base, DIST_DEPTH_B)
    model = LM(cfg, device=dev)
    rows = TRAIN_BATCH * DIST_WORLD // 2 * DIST_ACCUM
    batch = host_batch(rows)
    t0 = time.perf_counter()
    mesh = dp_mesh
    with compute_dtype(torch.float32), \
            shd.use_sharding(mesh, shd.DEFAULT_RULES):
        params = training_params(model, torch.Generator(device=dev)
                                 .manual_seed(SEED))
        opt = adamw_init(params)
        mark("b: step")
        step = make_train_step_reduce_once(model, opt_cfg, DIST_ACCUM,
                                           mesh)
        _sync(torch, dev)
        K.reset_launch_counts()
        t1 = time.perf_counter()
        loss, metrics, grads = step.grads(params, batch)
        _sync(torch, dev)
        grads_s = time.perf_counter() - t1
        launches_b = K.launch_counts()
        mem.append(_mem_used(torch, dev))
        flat_g = flatten_pytree(grads)
        mark("b: collectives")
        small = {n: g for n, g in flat_g.items()
                 if "/attn/" in n or n.endswith("/router")}
        t1 = time.perf_counter()
        on_card, fb_card = compressed_psum_tree(small, dist.group.WORLD)
        on_host, fb_host = compressed_psum_tree(
            {n: g.cpu() for n, g in small.items()}, dist.group.WORLD)
        compressed = {"leaves": len(small),
                      "elements": sum(g.numel() for g in small.values()),
                      "bit_equal": all(
                          torch.equal(on_card[n].cpu(), on_host[n])
                          and torch.equal(fb_card[n].cpu(), fb_host[n])
                          for n in small),
                      "seconds": time.perf_counter() - t1}
        leaf = flat_g["segments/0/attn/wq"]
        shard_, gather = reduce_scatter_then_gather(leaf,
                                                    dist.group.WORLD)
        summed = leaf.clone()
        dist.all_reduce(summed)
        rs_equal = torch.equal(gather(shard_), summed)
        del on_card, fb_card, on_host, fb_host, small, shard_, summed
    from repro_torch.models.params import tree_map

    def mine(t):
        return t.to_local()
    replica = tree_map(mine, params)        # this rank's whole copy
    res["b"] = {"mesh": [DIST_WORLD, 1], "layers": cfg.n_layers,
                "params": model.num_params(), "rows": rows,
                "grad_accum": DIST_ACCUM, "loss": float(loss),
                "grads_seconds": grads_s, "setup_seconds": t1 - t0,
                "launches": launches_b, "compressed_psum": compressed,
                "reduce_scatter_equals_all_reduce": rs_equal}
    mark("b: oracle")
    if rank == 0:       # the oracle: no mesh, the same 4 rows, 1 a step
        t0 = time.perf_counter()
        with compute_dtype(torch.float32):
            g = tree_map(torch.zeros_like, replica)
            losses = []
            n = rows // (DIST_WORLD * DIST_ACCUM)
            for i in range(DIST_WORLD * DIST_ACCUM):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                losses.append(value_and_grad(model, replica, mb, g)[0])
            mem.append(_mem_used(torch, dev))
        want = {nm: t / (DIST_WORLD * DIST_ACCUM)
                for nm, t in flatten_pytree(g).items()}
        ref_loss = float(sum(losses)) / len(losses)
        gaps = _leaf_gaps(flat_g, want)
        router = {nm: v for nm, v in gaps.items()
                  if nm.endswith("/router")}
        rest = {nm: v for nm, v in gaps.items() if nm not in router}
        res["b"].update(
            oracle_loss=ref_loss,
            loss_gap=abs(float(loss) - ref_loss) / abs(ref_loss),
            grad_gap_max=max(rest.values()), router_gap=router,
            grad_gaps_largest=dict(sorted(rest.items(),
                                          key=lambda kv: -kv[1])[:6]),
            oracle_seconds=time.perf_counter() - t0)
        del g, want
    dist.barrier()
    del replica, flat_g, leaf
    # the step itself: AdamW on the reduced gradients (``step.apply``),
    # with replicated moments and, on a copy of the params, with ZeRO-1
    # moments split over "data": the params must come out bit-equal
    t1 = time.perf_counter()
    with shd.use_sharding(mesh, shd.DEFAULT_RULES):
        params_z = tree_map(lambda t: t.clone(), params)
        opt_z = adamw_init(params_z, zero1=True, skeleton=model.skeleton())
        grads_z = tree_map(lambda t: t.clone(), grads)
        step.apply(params, opt, grads)
        _sync(torch, dev)
        res["b"]["update_seconds"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        step.apply(params_z, opt_z, grads_z)
        _sync(torch, dev)

    def moment_bytes(state):
        return sum(t.to_local().numel() * t.to_local().element_size()
                   for k in ("m", "v") for t in flatten_pytree(
                       state[k]).values())
    res["b"]["zero1"] = {
        "update_seconds": time.perf_counter() - t1,
        "params_bit_equal": all(
            torch.equal(a.to_local(), b.to_local()) for a, b in zip(
                flatten_pytree(params).values(),
                flatten_pytree(params_z).values())),
        "moment_bytes": moment_bytes(opt_z),
        "replicated_moment_bytes": moment_bytes(opt),
        "split_leaves": sum(t.placements != p.placements for t, p in zip(
            flatten_pytree(opt_z["m"]).values(),
            flatten_pytree(params).values())),
        "leaves": len(flatten_pytree(params))}
    del params, opt, grads, metrics, params_z, opt_z, grads_z
    dist.barrier()
    free()
    dist.barrier()
    free()
    mark("done")
    res.update(stages=dict(mark.stages),
               peak_allocated=torch.cuda.max_memory_allocated()
               if dev.type == "cuda" else 0,
               mem_used_max=max(mem), t_enter=t_enter,
               t_import=t_import, t_go=t_go,
               t_done=time.time())
    return res


def start_world(dev, smoke: bool = False) -> dict:
    """Spawn phase 26's ranks (``dist_worker``): they import and join the
    world while earlier phases run, and wait for ``distributed`` to set
    their ``go`` event before they touch the card."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    queue, go = ctx.Queue(), ctx.Event()
    work = ROOT / "build" / "chip_smoke" / ("dist_smoke" if smoke
                                            else "dist")
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    init = f"file://{work / 'store'}"
    procs = [ctx.Process(target=dist_worker, args=(
        r, queue, go, init, str(work / "ckpt"), dev.type, smoke),
        daemon=True) for r in range(DIST_WORLD)]
    t0 = time.time()
    for p in procs:
        p.start()
    return {"procs": procs, "queue": queue, "go": go, "work": work,
            "t0": t0}


def distributed(torch, dev, K, smoke: bool = False, world=None) -> dict:
    """26: the distributed slice in a world of DIST_WORLD spawned ranks on
    the one card (``dist_worker``; ``world`` from ``start_world`` if the
    ranks were started early), then its gates: every rank ended without
    error; (a) loss within DIST_LOSS_GAP, every gradient leaf within
    DIST_GRAD_GAP of the oracle's, each rank's per-shard flash launches;
    (b) every leaf but the router's within DIST_GRAD_GAP, the compressed
    sum bit-equal to the CPU's, the reduce-scatter + gather equal to the
    all-reduce; (c) every restored block equal, the blocks those
    MeshSharding gives; the card's memory in use (all processes) under
    75 GB."""
    world = world or start_world(dev, smoke)
    procs, queue, work = world["procs"], world["queue"], world["work"]
    t0 = time.time()
    world["go"].set()
    deadline = time.monotonic() + DIST_WAIT_S
    ranks = []
    try:
        while len(ranks) < DIST_WORLD:
            try:
                r = queue.get(timeout=1.0)
            except Exception:           # noqa: BLE001 - queue.Empty
                dead = {i: p.exitcode for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0)}
                if dead or time.monotonic() > deadline:
                    trails = {i: (work / f"rank{i}.trail").read_text()[:3000]
                              for i in range(DIST_WORLD)
                              if (work / f"rank{i}.trail").exists()}
                    raise AssertionError(
                        (f"ranks died without a report (exit codes "
                         f"{dead})" if dead else
                         "the world outlived its deadline")
                        + f"; their trails: {trails}")
                continue
            if "error" in r:
                raise AssertionError(f"rank {r['rank']} failed: "
                                     f"{r['error']}\n{r['traceback']}")
            ranks.append(r)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        bad = [p.exitcode for p in procs if p.exitcode != 0]
        if bad:
            raise AssertionError(f"ranks exited with {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10.0)
        shutil.rmtree(work, ignore_errors=True)
    ranks.sort(key=lambda r: r["rank"])
    for r in ranks:
        r["spawn_import_seconds"] = r.pop("t_import") - world["t0"]
        r["waited_seconds"] = r["t_go"] - r["spawn_import_seconds"] \
            - world["t0"]
        r["work_seconds"] = r.pop("t_done") - r.pop("t_go")
        r.pop("t_enter")
    r0 = ranks[0]
    a, b, c = r0["a"], r0["b"], r0["c"]
    out = {"world": DIST_WORLD, "backend": "gloo", "ranks": ranks,
           "wall_seconds": time.time() - t0,
           "mem_used_max": max(r["mem_used_max"] for r in ranks),
           "peak_allocated_sum": sum(r["peak_allocated"] for r in ranks)}
    fails = []
    if any(v != "ok" for r in ranks for k, v in r["collectives"].items()
           if k in ("all_reduce", "all_gather_into_tensor")):
        fails.append("gloo refused a collective the slice needs")
    if not a["loss_gap"] < DIST_LOSS_GAP:
        fails.append(f"(a) loss gap {a['loss_gap']}")
    if not a["grad_gap_max"] < DIST_GRAD_GAP:
        fails.append(f"(a) gradient gaps {a['grad_gaps_largest']}")
    if not b["grad_gap_max"] < DIST_GRAD_GAP:
        fails.append(f"(b) gradient gaps {b['grad_gaps_largest']}")
    if not all(r["b"]["compressed_psum"]["bit_equal"] for r in ranks):
        fails.append("(b) compressed_psum_tree differs from the CPU's")
    if not all(r["b"]["reduce_scatter_equals_all_reduce"] for r in ranks):
        fails.append("(b) reduce_scatter_then_gather differs")
    if not all(r["c"]["restored_equal"] for r in ranks):
        fails.append("(c) a restored block differs: ranks "
                     + str([r["rank"] for r in ranks
                            if not r["c"]["restored_equal"]]))
    if c["blocks"] != c["mesh_sharding_blocks"]:
        fails.append(f"(c) {c['blocks']} blocks, MeshSharding gives "
                     f"{c['mesh_sharding_blocks']}")
    if dev.type == "cuda" and not (c["pack_rows_save"]
                                   and c["pack_rows_restore"]):
        fails.append(f"(c) pack_rows launches {c}")
    # f32 compute: each shard's attention on the 3xTF32 kernels, one
    # forward, one dq and one dkv a layer and microbatch, and (a) under
    # remat one more forward a layer (the recompute); (b)'s single-layer
    # segment runs without remat; the bf16 step the same on the sm90
    # kernels
    D = a["head_dim"]
    fwd_a = DIST_DEPTH_A * (2 if a["remat"] != "none" else 1)
    for r in ranks if dev.type == "cuda" else ():
        for part, route, n, fwd, launched in (
                ("a", "f32tc", DIST_DEPTH_A, fwd_a, r["a"]["launches"]),
                ("a, bf16 step", "sm90", DIST_DEPTH_A, fwd_a,
                 r["a"]["bf16_step"]["launches"]),
                ("b", "f32tc", DIST_DEPTH_B * DIST_ACCUM,
                 DIST_DEPTH_B * DIST_ACCUM, r["b"]["launches"])):
            got = {k: launched[k] for k in FLASH_KERNELS}
            want = dict.fromkeys(FLASH_KERNELS, 0)
            want[flash_kernel("fwd", route, D)] = fwd
            want[flash_kernel("dq", route, D)] = n
            want[flash_kernel("dkv", route, D)] = n
            if got != want:
                fails.append(f"rank {r['rank']} ({part}) launched {got}, "
                             f"not {want}")
    if a["remat"] != "dots":
        fails.append(f"(a) ran under remat={a['remat']!r}, not the "
                     f"config's 'dots'")
    bf = a["bf16_step"]
    if not bf["loss_gap"] < DIST_LOSS_GAP_BF16:
        fails.append(f"(a, bf16 step) loss gap {bf['loss_gap']}")
    if not bf["grad_gap_max"] < GRAD_GAP_BF16 or \
            bf["layers"] != bf["oracle_layers"] or not bf["layers"]:
        fails.append(f"(a, bf16 step) gradient gaps {bf['grad_gaps']} "
                     f"over {bf['layers']} layers")
    for r in ranks:
        z = r["b"]["zero1"]
        if not z["params_bit_equal"]:
            fails.append(f"rank {r['rank']} (b) zero1 params differ from "
                         f"the replicated-moment step's")
        if 2 * z["moment_bytes"] != z["replicated_moment_bytes"]:
            fails.append(f"rank {r['rank']} (b) zero1 moments take "
                         f"{z['moment_bytes']} bytes, not half of "
                         f"{z['replicated_moment_bytes']}")
    # bf16: the sm90 kernels per shard, once each, at half the heads
    for r in ranks:
        fl = r["a"]["bf16_flash"]
        if not max(fl["gaps"].values()) < BWD_TOL["bfloat16"][0]:
            fails.append(f"rank {r['rank']} (a, bf16) flash gaps "
                         f"{fl['gaps']}")
        want = dict.fromkeys(FLASH_KERNELS, 0)
        for kind in ("fwd", "dq", "dkv"):
            want[flash_kernel(kind, "sm90", D)] = 1
        got = {k: fl["launches"][k] for k in FLASH_KERNELS}
        if dev.type == "cuda" and got != want:
            fails.append(f"rank {r['rank']} (a, bf16) launched {got}, "
                         f"not {want}")
    if out["mem_used_max"] >= DIST_MEM_BYTES:
        fails.append(f"the card's memory in use reached "
                     f"{out['mem_used_max']}")
    if fails:
        raise AssertionError("; ".join(fails))
    return out


# -- phase 27 ------------------------------------------------------------------

#: 27b: one production cell traced on a fake (16, 16) world at full width
#: and depth, in a subprocess (``python -m repro_torch.launch.dryrun``)
DRYRUN_CELL = ("qwen2.5-3b", "decode_32k")
#: the H100 SXM's dense bf16 peak (data sheet), the MFU's denominator
PEAK_BF16_FLOPS = 989.4e12
#: 27a's timed steps after the counted one (the median is the step time)
TOOLING_STEPS = 3


def start_dryrun() -> dict:
    """27b's dry run, started while earlier phases run: the subprocess
    traces DRYRUN_CELL on a fake single-pod world on the card's device
    type and writes its record under ``build/chip_smoke``."""
    out = ROOT / "build" / "chip_smoke" / "dryrun_27b.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    arch, shape = DRYRUN_CELL
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "single", "--out", str(out),
         "--jobs", "1"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return {"proc": proc, "out": out, "t0": time.time()}


def launch_tooling(torch, dev, K, dry) -> dict:
    """27: (a) phase 11's step (qwen2.5-3b at QWEN_TRAIN_DEPTH layers, 2 x
    2048 tokens, bf16, ``remat="dots"``, flash on, no mesh) traced fake
    through ``build_cell`` on the card's device type and counted for real
    on the card by ``analyze_ops``: the fake trace's flops must equal the
    real step's; its predicted peak beside ``max_memory_allocated``; the
    step's model flops (``model_flops_estimate``) over the median of
    TOOLING_STEPS more steps and over the bf16 peak: the achieved model
    TFLOP/s and MFU.  (b) ``dry``'s record (``start_dryrun``): status
    ``ok`` and its per-device peak under the card's CARD_BYTES."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.common import ShapeCell
    from repro_torch.data import PipelineConfig, SyntheticTokens
    from repro_torch.launch.dryrun import trace
    from repro_torch.launch.op_analysis import analyze_ops
    from repro_torch.launch.specs import build_cell, model_flops_estimate
    from repro_torch.models import LM
    from repro_torch.train import (OptimizerConfig, adamw_init,
                                   make_train_step)
    cfg = cut_depth(dataclasses.replace(get_config(SERVE_ARCH), flash=True,
                                        grad_accum=1), QWEN_TRAIN_DEPTH)
    shape = ShapeCell("train_phase11", "train", TRAIN_SEQ, TRAIN_BATCH)
    opt_cfg = OptimizerConfig(**TRAIN_OPT)
    t0 = time.perf_counter()
    cell = build_cell(SERVE_ARCH, "train_4k", opt_cfg=opt_cfg,
                      device=dev.type, cfg=cfg, shape=shape)
    fake, memory = trace(cell)
    trace_s = time.perf_counter() - t0
    model = LM(cfg, device=dev)
    params = training_params(model, torch.Generator(device=dev)
                             .manual_seed(SEED))
    opt = adamw_init(params)
    host = next(SyntheticTokens(PipelineConfig(
        global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, vocab=cfg.vocab,
        seed=SEED, frontend=cfg.frontend, d_model=cfg.d_model)))
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    step = make_train_step(model, opt_cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    real = analyze_ops(step, params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = K.launch_counts()
    times = []
    for _ in range(TOOLING_STEPS):
        t1 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    del params, opt, batch, step
    step_s = statistics.median(times)
    model_flops = model_flops_estimate(model, shape)
    out = {"a": {
        "layers": cfg.n_layers, "tokens": TRAIN_BATCH * TRAIN_SEQ,
        "trace_seconds": trace_s, "fake_flops": fake.cost.flops,
        "real_flops": real.flops, "fake_bytes": fake.cost.bytes,
        "real_bytes": real.bytes, "predicted_peak_bytes":
            memory["peak_bytes_per_dev"], "memory": memory,
        "max_memory_allocated": peak,
        "peak_gap": (memory["peak_bytes_per_dev"] - peak) / peak,
        "launches": launches, "step_seconds": times,
        "model_flops": model_flops,
        "model_tflops_per_s": model_flops / step_s / 1e12,
        "mfu": model_flops / step_s / PEAK_BF16_FLOPS,
        "peak_bf16_flops": PEAK_BF16_FLOPS}}
    # (b) the production cell
    try:
        stdout, stderr = dry["proc"].communicate(timeout=300)
    finally:
        if dry["proc"].poll() is None:
            dry["proc"].kill()
            dry["proc"].communicate()
    recs = json.loads(dry["out"].read_text()) if dry["out"].exists() \
        else []
    rec = recs[0] if recs else {"status": "missing",
                                "error": stderr[-3000:]}
    out["b"] = {"arch": DRYRUN_CELL[0], "shape": DRYRUN_CELL[1],
                "exit_code": dry["proc"].returncode,
                "wall_seconds": time.time() - dry["t0"],
                **{k: v for k, v in rec.items() if k != "traceback"}}
    fails = []
    if out["a"]["fake_flops"] != out["a"]["real_flops"]:
        fails.append(f"(a) the fake trace counted {fake.cost.flops} flops, "
                     f"the real step {real.flops}")
    if rec.get("status") != "ok":
        fails.append(f"(b) {DRYRUN_CELL} is {rec.get('status')}: "
                     f"{rec.get('error')} {rec.get('traceback', '')}")
    elif not rec["memory"]["peak_bytes_per_dev"] < CARD_BYTES:
        fails.append(f"(b) {DRYRUN_CELL} needs "
                     f"{rec['memory']['peak_bytes_per_dev']} bytes a card")
    if fails:
        raise AssertionError("; ".join(fails))
    return out


def main(argv) -> int:
    t_start = time.perf_counter()
    moe_serving = argv == ["--moe-serving"]
    if argv and not moe_serving:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
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
    if moe_serving:
        t0 = time.perf_counter()
        moe = serve_moe(torch, dev, K)
        emit(22, seconds=time.perf_counter() - t0, **moe)
        emit("total", seconds=time.perf_counter() - t_start)
        print(smi_line(), flush=True)
        return 0

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
    trained = train(torch, dev, K, hand_over=state, depth=QWEN_TRAIN_DEPTH)
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
    trained_g = train(torch, dev, K, GEMMA2_ARCH, depth=GEMMA2_TRAIN_DEPTH)
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
    saves = async_checkpoints(torch, dev, K)
    emit("17b", seconds=time.perf_counter() - t0, **saves)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    bypass = engines(torch, dev, K, blocks)
    emit(18, seconds=time.perf_counter() - t0, **bypass)

    t0 = time.perf_counter()
    replayed = replay(torch, dev, K)
    emit(19, seconds=time.perf_counter() - t0, **replayed)

    t0 = time.perf_counter()
    ssd, _ = serve_ssm(torch, dev, K, SSM_ARCH)
    torch.cuda.empty_cache()
    emit("20a", seconds=time.perf_counter() - t0, **ssd)
    t0 = time.perf_counter()
    hybrid, state = serve_ssm(torch, dev, K, HYBRID_ARCH)
    emit("20b", seconds=time.perf_counter() - t0, **hybrid)
    t0 = time.perf_counter()
    snap = snapshot(torch, dev, K, state.pop("model"), state.pop("params"))
    torch.cuda.empty_cache()
    emit("20c", seconds=time.perf_counter() - t0, **snap)

    t0 = time.perf_counter()
    trained_s = train(torch, dev, K, SSM_ARCH, depth=SSM_TRAIN_DEPTH)
    emit("21a", seconds=time.perf_counter() - t0, **trained_s)
    check_training(trained_s)
    t0 = time.perf_counter()
    trained_h = train(torch, dev, K, HYBRID_ARCH)
    emit("21b", seconds=time.perf_counter() - t0, **trained_h)
    check_training(trained_h)
    torch.cuda.empty_cache()

    # phase 26's ranks import and join their world while 23-25 run; they
    # wait for the card until ``distributed`` lets them go; 27b's dry run
    # traces on the host meanwhile
    world = start_world(dev)
    dry = start_dryrun()
    t0 = time.perf_counter()
    trained_e = encoder(torch, dev, K)
    emit(23, seconds=time.perf_counter() - t0, **trained_e)
    t0 = time.perf_counter()
    vlm = serve_vlm(torch, dev, K)
    emit(24, seconds=time.perf_counter() - t0, **vlm)
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    trained_m = train_moe(torch, dev, K)
    emit(25, seconds=time.perf_counter() - t0, **trained_m)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sharded = distributed(torch, dev, K, world=world)
    emit(26, seconds=time.perf_counter() - t0, **sharded)
    t0 = time.perf_counter()
    tooling = launch_tooling(torch, dev, K, dry)
    torch.cuda.empty_cache()
    a = tooling["a"]
    print(f"27a: {a['model_tflops_per_s']:.2f} model TFLOP/s, MFU "
          f"{a['mfu']:.4f} of {PEAK_BF16_FLOPS:.4g} ({SERVE_ARCH} at "
          f"{a['layers']} layers, {a['tokens']} tokens a step, median of "
          f"{TOOLING_STEPS} steps)", flush=True)
    emit(27, seconds=time.perf_counter() - t0, **tooling)
    emit("total", seconds=time.perf_counter() - t_start)

    # the copy kernels' launches on their nine paths: the slice-1 step
    # (phase 3), the checkpoint path (phase 15), the reorganization path
    # with the read service (phase 16), the staged output (phase 17a), the
    # async checkpoints (phase 17b), the kernel-bypass engines with the
    # distributed fleet (phase 18, the fleet workers' launches included),
    # the trace replays (phase 19), the serving-state snapshot (20c) and
    # the sharded checkpoint (26c, both ranks)
    rows = [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces,
             "launches": launches[name] + ckpt["launches"][name]
             + reorganized["launches"][name] + online["launches"][name]
             + saves["launches"][name] + bypass["launches"][name]
             + replayed["launches"][name] + snap["launches"][name]
             + sum(r["c"][f"{name}_save"] + r["c"][f"{name}_restore"]
                   for r in sharded["ranks"] if f"{name}_save" in r["c"]),
             "max_abs_err": checks["max_abs_err"][name],
             "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
             "bound_ms": times[name]["bound_ms"], "bound_by": "bytes",
             "library_ms": times[name]["library_ms"]}
            for name, (source, replaces) in KERNELS.items()
            if not name.startswith("flash_attention")]
    # the sm90 forward's two kernels on the serving runs (qwen2.5-3b's,
    # hymba-1.5b's and the VLM's head_dim up to 128, gemma2-2b's 256), the
    # training runs (forward and remat recompute; hubert-xlarge's head_dim
    # 80 non-causal; deepseek-moe-16b's) and the encoder's prefill; the
    # 3xTF32 forward on the f32 serving prefills (qwen2.5-3b's,
    # gemma2-2b's, hymba-1.5b's, the VLM's), the f32 training comparisons
    # and phase 26's sharded f32 steps, the paths that run it here.
    # The CUDA-core forward runs on no path, so the summary, the kernels
    # of the paths, leaves it out: phase 6 checks it against its plain
    # version, phase 8 times it
    served_runs = (served, gemma2, hybrid, vlm)
    trained_runs = (trained, trained_g, trained_h, trained_e, trained_m)
    # the f32 route comparisons and phase 26's sharded f32 steps, both
    # ranks' per-shard launches (parts a and b)
    f32_runs = [r["flash_vs_q_chunked"]["float32"]["flash_launches"]
                for r in served_runs + trained_runs
                if "float32" in r["flash_vs_q_chunked"]] + [
        r[part]["launches"] for r in sharded["ranks"] for part in "ab"]

    def total(name):
        """``name``'s launches on the serving and training runs (the
        encoder's prefill too), phase 26a's bf16 per-shard call and step
        and phase 27a's counted step."""
        return sum(r["launches"][name] for r in served_runs + trained_runs
                   ) + trained_e["prefill"]["launches"][name] + sum(
            r["a"]["bf16_flash"]["launches"][name]
            + r["a"]["bf16_step"]["launches"][name]
            for r in sharded["ranks"]) + tooling["a"]["launches"][name]

    for name, launched, t in (
            ("flash_attention", total("flash_attention"),
             flash_times["serving"]),
            ("flash_attention_d256", total("flash_attention_d256"),
             flash_times["gemma2"]),
            ("flash_attention_f32tc",
             sum(r["flash_attention_f32tc"] for r in f32_runs),
             flash_times["f32_serving"])):
        source, replaces = KERNELS[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched,
                     "max_abs_err": flash_check["max_abs_err"][name],
                     "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    # the sm90 backward on the training runs (qwen2.5-3b's, hymba-1.5b's
    # and hubert-xlarge's head_dim up to 128, gemma2-2b's 256); the 3xTF32
    # backward on the f32 route comparisons, the paths that run it here.
    # The CUDA-core backward runs on no path: phase 10 checks it, phase 12
    # times it
    for name, launched, t in (
            ("flash_attention_dq", total("flash_attention_dq"),
             bwd_times["training"]["flash_attention_dq"]),
            ("flash_attention_dq_d256", total("flash_attention_dq_d256"),
             bwd_times["gemma2"]["flash_attention_dq_d256"]),
            ("flash_attention_dq_f32tc",
             sum(r["flash_attention_dq_f32tc"] for r in f32_runs),
             bwd_times["training_f32"]["flash_attention_dq_f32tc"]),
            ("flash_attention_dkv", total("flash_attention_dkv"),
             bwd_times["training"]["flash_attention_dkv"]),
            ("flash_attention_dkv_d256", total("flash_attention_dkv_d256"),
             bwd_times["gemma2"]["flash_attention_dkv_d256"]),
            ("flash_attention_dkv_f32tc",
             sum(r["flash_attention_dkv_f32tc"] for r in f32_runs),
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
    sys.exit(main(sys.argv[1:]))
