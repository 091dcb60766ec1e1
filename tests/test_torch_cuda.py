"""The CUDA kernels on the card: each against its plain version (the
copies bit-exact, flash attention and its backward within the reference's
own f32 tolerances), and the slices end to end through them.  Marked ``cuda``; they
skip where there is no GPU (run them on one with
``python -m pytest -m cuda tests/test_torch_cuda.py``)."""

import importlib

import numpy as np
import pytest
import torch

import repro_torch.core as tc
import repro_torch.kernels as K
from repro_torch.core.blocks import Block
from repro_torch.io import Dataset
from repro_torch.kernels.ref import (chunked_to_rowmajor_ref,
                                     flash_attention_dkv_ref,
                                     flash_attention_dq_ref,
                                     flash_attention_ref, pack_rows_ref,
                                     rowmajor_to_chunked_ref)

pytestmark = pytest.mark.cuda

DTYPES = (torch.float32, torch.bfloat16, torch.int32, torch.int8)
# the package's ``flash_attention`` attribute is the function, not the module
FA = importlib.import_module("repro_torch.kernels.flash_attention")
#: the forward's routes, by their kernels' launch counters (the sm90
#: route's head_dim-128 and head_dim-256 kernels; the f32 forward's 3xTF32
#: kernel; the CUDA-core kernel, run only when named)
ROUTES = {"sm90": ("flash_attention", "flash_attention_d256"),
          "f32tc": ("flash_attention_f32tc",),
          "simt": ("flash_attention_simt",)}
#: the backward's routes, by their (dq, dkv) kernels' launch counters
BWD_ROUTES = {"sm90": (("flash_attention_dq", "flash_attention_dq_d256"),
                       ("flash_attention_dkv", "flash_attention_dkv_d256")),
              "f32tc": (("flash_attention_dq_f32tc",),
                        ("flash_attention_dkv_f32tc",)),
              "simt": (("flash_attention_dq_simt",),
                       ("flash_attention_dkv_simt",))}
MASKS = [(True, None, None), (False, None, None), (True, 48, None),
         (True, None, 30.0), (False, 48, 30.0)]


def _launches(fn):
    """``fn()`` and each flash kernel's launches during it."""
    before = K.launch_counts()
    out = fn()
    after = K.launch_counts()
    return out, {n: after[n] - before[n] for n in after
                 if n.startswith("flash")}


def _routes(ran):
    """The forward's launches on each route: the sum of its kernels'."""
    return {r: sum(ran[n] for n in names) for r, names in ROUTES.items()}


def _bwd_routes(ran):
    """The backward's (dq, dkv) launches on each route: the sums of its
    kernels'."""
    return {r: tuple(sum(ran[n] for n in kind) for kind in names)
            for r, names in BWD_ROUTES.items()}


def _bwd_on_route(args, route):
    """dQ and per-q-head dK, dV on the named route, through the wrapper's
    module-private launcher."""
    q, k = args[0], args[1]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk, dv = (torch.empty((q.shape[0], q.shape[1], k.shape[2], q.shape[3]),
                          dtype=torch.float32, device=q.device)
              for _ in range(2))
    FA._launch_bwd("dq", (dq,), *args, route=route)
    FA._launch_bwd("dkv", (dk, dv), *args, route=route)
    return dq, dk, dv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("n,width", [(32, 128), (64, 256), (16, 512),
                                     (40, 3), (40, 7)])
def test_pack_rows_kernel_matches_plain(cuda, dtype, n, width):
    rng = np.random.default_rng([n, width])
    src = torch.from_numpy(rng.integers(-100, 100, (n, width))
                           .astype(np.float32)).to(dtype).to(cuda)
    m = n + 8
    sr = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(cuda)
    dr = torch.from_numpy(rng.choice(m, n, replace=False)
                          .astype(np.int32)).to(cuda)
    before = K.pack_rows.launches
    got = K.pack_rows(src, sr, dr, n_dst_rows=m, width=width)
    assert K.pack_rows.launches == before + 1
    assert torch.equal(got, pack_rows_ref(src, sr, dr, n_dst_rows=m,
                                          width=width))


@pytest.mark.parametrize("covered", [True, False],
                         ids=["covering", "with_a_hole"])
def test_pack_tables_makes_no_device_to_host_sync(cuda, covered):
    """``ops.pack_tables`` as the main path calls it: the numpy tables of
    ``plan_row_tables`` checked on the host, sent in one asynchronous copy,
    and on tables that name every destination row the output left
    unfilled.  Under ``torch.cuda.set_sync_debug_mode("error")`` it makes
    no device-to-host sync; one launch, the plain version's bytes, and
    zeros in the rows of a cluster that no block names (the output
    allocated where NaN lay just before)."""
    from repro_torch.core.clustering import Cluster
    from repro_torch.core.merge import plan_from_clusters
    from repro_torch.kernels.ops import pack_tables
    from repro_torch.kernels.ref import plan_row_tables
    shape = (64, 64) if covered else (64, 96)
    second = Block((32, 0), (64, 64), block_id=1) if covered else \
        Block((32, 32), (64, 96), block_id=1)
    tables = plan_row_tables(plan_from_clusters([Cluster(
        Block((0, 0), shape), (Block((0, 0), (32, 64), block_id=0),
                               second))]))
    width, sr, dr, total, _ = tables
    src = torch.randn(2 * 32 * 64, device=cuda)
    want = pack_rows_ref(src, torch.from_numpy(sr).to(cuda),
                         torch.from_numpy(dr).to(cuda),
                         n_dst_rows=total // width, width=width).reshape(-1)
    before = K.pack_rows.launches
    pack_tables(src, tables, _covered=covered)      # build and warm up
    torch.full((total,), float("nan"), device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = pack_tables(src, tables, _covered=covered)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert K.pack_rows.launches == before + 2
    assert torch.equal(got, want)
    if not covered:
        assert not got.view(shape)[:32, 64:].any()
        assert not got.view(shape)[32:, :32].any()


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("grid,chunk", [((4, 2), (8, 128)),
                                        ((2, 4), (16, 128)),
                                        ((3, 3), (8, 256)), ((2, 3), (5, 3))])
def test_relayout_kernels_match_plain(cuda, dtype, grid, chunk):
    x = torch.randn((*grid, *chunk), device=cuda).to(dtype)
    rm = K.chunked_to_rowmajor(x, chunk=chunk)
    assert torch.equal(rm, chunked_to_rowmajor_ref(x))
    back = K.rowmajor_to_chunked(rm, chunk=chunk)
    assert torch.equal(back, rowmajor_to_chunked_ref(rm, chunk))
    assert torch.equal(back, x)


@pytest.mark.parametrize("strategy", ["merged_process", "reorganized"])
def test_slice_through_the_kernels(cuda, tmp_path, strategy):
    shape = (256, 256)
    blocks = tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, (32, 32)), num_procs=8, seed=0)
    field = torch.randn(shape, device=cuda)
    data = {b.block_id: field[b.slices()].contiguous() for b in blocks}
    layout = tc.plan_layout(strategy, blocks, num_procs=8)
    K.reset_launch_counts()
    ds = Dataset.create(str(tmp_path))
    ds.write("E", layout, np.float32, data)
    got, _ = ds.read("E", Block((0, 0), shape))
    assert got.device == field.device and torch.equal(got, field)
    counts = K.launch_counts()
    assert counts["pack_rows"] >= 1
    if strategy == "reorganized":
        assert counts["rowmajor_to_chunked"] == 1
        assert counts["chunked_to_rowmajor"] == 1
    ds.close()


@pytest.mark.parametrize("strategy", ["merged_process", "reorganized"])
def test_region_route_matches_the_host_route(cuda, tmp_path, strategy):
    """Regions that cut chunks, several sharing a chunk, and a one-column
    region (width 1) in one ``read_regions`` call: one ``pack_rows``
    launch, the host route's bytes on the card."""
    from repro_torch.io.device import read_regions
    shape = (256, 192)
    blocks = tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, (32, 32)), num_procs=8, seed=1)
    field = torch.randn(shape, device=cuda)
    layout = tc.plan_layout(strategy, blocks, num_procs=8)
    ds = Dataset.create(str(tmp_path), device=cuda)
    ds.write("E", layout, np.float32,
             {b.block_id: field[b.slices()] for b in blocks})
    regions = [Block((5, 17), (200, 150)), Block((100, 0), (256, 192)),
               Block((0, 33), (256, 34))]
    K.reset_launch_counts()
    got, st = read_regions(ds, "E", regions, cuda)
    torch.cuda.synchronize()
    assert K.launch_counts()["pack_rows"] == 1
    for r, t in zip(regions, got):
        host, hs = ds.read_planned(ds.plan_read("E", r))
        assert t.device == cuda and torch.equal(t.cpu(),
                                                torch.from_numpy(host))
        assert torch.equal(t, field[r.slices()])
    assert st.bytes_read == sum(ds.plan_read("E", r).bytes_needed
                                for r in regions)
    ds.close()


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A tree of CUDA tensors saved from MeshShardings (2 hosts x 4
    devices) under merged_process: one ``pack_rows`` launch a leaf on the
    save; the whole restore, bit-exact, on the card; an elastic restore
    onto another axis, one launch a variable; the int32 scalar 0-d."""
    from repro_torch.checkpoint import CheckpointManager, MeshSharding
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"embed": torch.randn((512, 64), generator=gen, device=cuda),
            "w": torch.randn((3, 64, 40), generator=gen, device=cuda),
            "count": torch.tensor(5, dtype=torch.int32, device=cuda)}
    ids = np.arange(8).reshape(2, 4)
    sh = {"embed": MeshSharding(ids, ("host", "dev"), (("host", "dev"),)),
          "w": MeshSharding(ids, ("host", "dev"),
                            (None, ("host", "dev")))}
    mgr = CheckpointManager(str(tmp_path), device=cuda)
    K.reset_launch_counts()
    st = mgr.save(1, tree, shardings=sh)
    assert K.launch_counts()["pack_rows"] == 2 and st.num_chunks == 4
    got, _ = mgr.restore(1, template=tree)
    for k, t in tree.items():
        assert got[k].device == cuda and torch.equal(got[k], t)
    assert got["count"].shape == () and got["count"].dtype == torch.int32
    targets = {"embed": tc.regular_decomposition((512, 64), (1, 4)),
               "w": tc.regular_decomposition((3, 64, 40), (1, 1, 4))}
    K.reset_launch_counts()
    flat, _ = mgr.restore(1, target_blocks=targets)
    assert K.launch_counts()["pack_rows"] == 2
    for k, blocks in targets.items():
        for b in blocks:
            assert torch.equal(flat[k][b.block_id], tree[k][b.slices()])


def test_reorganize_and_read_pattern_on_the_card(cuda, tmp_path):
    """A small ``reorganize`` on the card: one ``pack_rows`` launch a
    gather batch, the destination's files equal to the CPU run's; then
    each pattern's decomposed read, one launch, with the CPU run's counts
    and the source's data."""
    from repro_torch.io import reorganize
    from repro_torch.io.device import gather_batches
    shape = (32, 48, 40)
    blocks = tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, (8, 16, 10)), num_procs=6, seed=3)
    field = torch.randn(shape, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    src = tmp_path / "src"
    ds = Dataset.create(str(src), device=cuda)
    ds.write("E", tc.plan_layout("merged_process", blocks, num_procs=6,
                                 procs_per_node=2), np.float32,
             {b.block_id: field[b.slices()].contiguous() for b in blocks})
    ds.close()
    target = tc.plan_reorganization(blocks, shape, None, num_stagers=3)
    files, stats = {}, {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        K.reset_launch_counts()
        _, dst, _ = reorganize(str(src), str(d), "E", target, device=dev)
        assert K.launch_counts()["pack_rows"] == (
            len(gather_batches(target, 4)) if dev == "cuda" else 0)
        files[dev] = {f.name: f.read_bytes() for f in sorted(d.iterdir())
                      if f.name != "reorg_stats.json"}
        stats[dev] = []
        for pattern in tc.PATTERNS:
            region = tc.pattern_region(pattern, shape)
            K.reset_launch_counts()
            st = dst.read_decomposed("E", region, (2, 2, 2))
            assert K.launch_counts()["pack_rows"] == (dev == "cuda")
            got, _ = dst.read("E", region)
            assert torch.equal(got.to(cuda), field[region.slices()])
            stats[dev].append((st.bytes_read, st.chunks_touched))
        dst.close()
    assert files["cuda"] == files["cpu"]
    assert stats["cuda"] == stats["cpu"]


def test_reads_reuse_the_sessions_pinned_buffer(cuda, tmp_path):
    """Part reads and whole reads on one thread of a session stage through
    one pinned buffer, grown only when a larger read needs it."""
    shape = (256, 192)
    blocks = tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, (32, 32)), num_procs=8, seed=1)
    field = torch.randn(shape, device=cuda)
    ds = Dataset.create(str(tmp_path), device=cuda)
    ds.write("E", tc.plan_layout("merged_process", blocks, num_procs=8),
             np.float32, {b.block_id: field[b.slices()] for b in blocks})
    part = Block((5, 17), (100, 150))
    got, _ = ds.read("E", part)
    buf = ds._staging.buffer()
    assert buf is not None and buf.is_pinned()
    for region in (part, Block((0, 0), (64, 64))):
        got, _ = ds.read("E", region)
        assert torch.equal(got, field[region.slices()])
        assert ds._staging.buffer() is buf
    got, _ = ds.read("E", Block((0, 0), shape))
    assert torch.equal(got, field)
    assert ds._staging.buffer().numel() >= field.numel() * 4
    ds.close()
    assert ds._staging.buffer() is None



def test_3d_intersection_route_matches_the_host_assembly(cuda):
    """A 3-D ``reorganized`` layout whose chunk edges cut through the
    boxes: ONE ``pack_rows`` launch fills every chunk on the card, each
    equal to the host assembly of the same blocks."""
    from repro_torch.io.device import assemble_chunks
    from repro_torch.io.engine import assemble_chunk
    shape = (48, 40, 36)
    blocks = tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, (12, 10, 9)), num_procs=6, seed=4)
    gen = torch.Generator(device=cuda).manual_seed(2)
    data = {b.block_id: torch.randn(b.shape, generator=gen, device=cuda)
            for b in blocks}
    host = {k: v.cpu().numpy() for k, v in data.items()}
    for scheme in ((4, 4, 4), (3, 5, 7)):
        layout = tc.plan_layout("reorganized", blocks, num_procs=6,
                                global_shape=shape, reorg_scheme=scheme)
        K.reset_launch_counts()
        bufs, stages = assemble_chunks(layout, data, np.float32)
        assert K.launch_counts()["pack_rows"] == 1 and stages
        for cp, buf in zip(layout.chunks, bufs):
            assert np.array_equal(buf, assemble_chunk(cp, host, np.float32))


def test_staging_workers_overlap_the_producer(cuda, tmp_path):
    """Two staging workers assemble and write on their own streams while
    the producer's kernel still runs and the producer updates its field
    in place after each submit: every step's bytes are the field as it
    was at its submit (a shared pinned buffer or a missing snapshot shows
    as wrong bytes), the workers finish before the producer's kernel does
    (a device-wide synchronize would wait for it), each through its own
    pinned buffer, and every chunk was assembled by ``pack_rows``."""
    from repro_torch.io import StagingExecutor
    shape = (64, 96, 80)
    blocks = tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, (16, 32, 20)), num_procs=6, seed=1)
    layout = tc.plan_layout("reorganized", blocks, num_procs=6,
                            global_shape=shape, reorg_scheme=(4, 4, 4),
                            num_stagers=2)
    field = torch.randn(shape, device=cuda)
    ex = StagingExecutor(str(tmp_path), num_workers=2, queue_depth=2,
                         engine="pread", device=cuda)
    K.reset_launch_counts()
    want = []
    ex.submit(0, "E", np.float32, layout, {b.block_id: field[b.slices()]
                                          for b in blocks})
    ex.drain()                              # the kernels are built now
    want.append(field.clone())
    producer = torch.cuda.Stream(cuda)
    producer.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(producer):
        for step in range(1, 5):
            field.mul_(1.5).add_(float(step))
            want.append(field.clone())
            ex.submit(step, "E", np.float32, layout,
                      {b.block_id: field[b.slices()] for b in blocks})
        done = torch.cuda.Event()
        torch.cuda._sleep(4_000_000_000)     # about two seconds of spinning
        done.record(producer)
        field.mul_(-1.0)                     # after the last submit
    res = ex.drain()
    assert not done.query(), "the workers waited for the producer's kernel"
    bufs = list(ex.dataset._staging._bufs.values())
    assert len({b.data_ptr() for b in bufs}) == len(bufs) >= 1
    ex.close()
    done.synchronize()
    assert [r.error for r in res] == [None] * 5
    assert K.launch_counts()["pack_rows"] == 5
    ds = Dataset.open(str(tmp_path), device=cuda)
    for step, w in enumerate(want):
        got, _ = ds.read(f"E@{step}", Block((0, 0, 0), shape))
        assert torch.equal(got, w), step
    ds.close()

@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("D", [16, 48, 80, 128, 256])
@pytest.mark.parametrize("causal,window,softcap",
                         [(True, None, None), (False, None, None),
                          (True, 48, None), (False, 48, 30.0)])
def test_flash_kernel_matches_plain(cuda, dtype, D, causal, window, softcap):
    """O within the reference's f32 tolerance (rtol 1e-4, atol 1e-5); bf16
    O within one bf16 step of the plain version's (both round one f32
    result: rtol 2^-7, atol 1e-5); LSE within 1e-4.  Lengths that are not
    multiples of the kernel's 64-row tiles, GQA groups of 4, a head dim
    (48) that runs zero-padded, and q, k of std sqrt(2), so the scores
    have std 2 and the online softmax rescales across k tiles.  bf16 runs
    the sm90 route (above head_dim 128 its head_dim-256 kernel), f32 the
    3xTF32 one."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    B, Hq, Hkv, L = 2, 8, 2, 150
    q, k, v = (std * torch.randn((B, h, L, D), generator=gen, device=cuda)
               for std, h in ((2 ** 0.5, Hq), (2 ** 0.5, Hkv), (0.5, Hkv)))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    (o, lse), ran = _launches(lambda: K.flash_attention(
        q, k, v, None, causal, window, softcap, return_lse=True))
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert _routes(ran) == {"sm90": int(bf16), "f32tc": int(not bf16),
                            "simt": 0}
    assert ran["flash_attention_d256"] == int(bf16 and D > 128)
    ro, rlse = flash_attention_ref(q, k, v, None, causal, window, softcap)
    assert o.dtype == dtype and lse.dtype == torch.float32
    tol = dict(rtol=1e-4, atol=1e-5) if dtype == torch.float32 else \
        dict(rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(o.float(), ro.float(), **tol)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 136, 200, 256])
@pytest.mark.parametrize("causal,window,softcap", MASKS)
def test_flash_sm90_kernel_matches_plain(cuda, D, causal, window, softcap):
    """The sm90 forward (bf16, every width its two kernels are built for,
    and 136 and 200 padded to 256, the five masks) against the plain
    version: O within one bf16 step (rtol 2^-7, atol 1e-5), LSE within
    1e-4.  Ragged Lq 150 and Lk 100 (neither a multiple of its 128-row q
    or 64-row k tiles), GQA groups of 4, q, k as (B, H, L, D) views of
    (B, L, H, D) tensors, read in place; each call counted once on the
    sm90 route, and above head_dim 128 once on its head_dim-256 kernel."""
    gen = torch.Generator(device=cuda).manual_seed(D + 2)
    B, Hq, Hkv, L, Lk = 2, 8, 2, 150, 100
    q, k, v = ((std * torch.randn((B, n, h, D), generator=gen, device=cuda))
               .bfloat16().transpose(1, 2)
               for std, h, n in ((2 ** 0.5, Hq, L), (2 ** 0.5, Hkv, Lk),
                                 (0.5, Hkv, Lk)))
    (o, lse), ran = _launches(lambda: K.flash_attention(
        q, k, v, None, causal, window, softcap, return_lse=True))
    torch.cuda.synchronize()
    assert _routes(ran) == {"sm90": 1, "f32tc": 0, "simt": 0}
    assert ran["flash_attention_d256"] == int(D > 128)
    ro, rlse = flash_attention_ref(q, k, v, None, causal, window, softcap)
    assert o.dtype == torch.bfloat16 and o.shape == (B, Hq, L, D)
    torch.testing.assert_close(o.float(), ro.float(), rtol=2 ** -7,
                               atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", [16, 24, 32, 48, 80, 128, 136, 200, 256])
@pytest.mark.parametrize("causal,window,softcap", MASKS)
def test_flash_f32tc_kernel_matches_plain(cuda, D, causal, window, softcap):
    """The 3xTF32 forward (``csrc/flash_fwd_f32tc.cu``) over the chip
    check's f32 sweep (phase 6): the five masks, GQA groups 1, 2, 4 and 8
    of 2 kv-heads, L 200 (Lk 136 for groups of 2), head dims that run
    padded (24, 48, 136, 200), q and k of std 1/2 and of std sqrt(2)
    (scores of std 2).  Each call one launch of the 3xTF32 kernel and none
    of another; O within the reference's f32 tolerance (rtol 1e-4, atol
    1e-5) of the plain version, LSE within 1e-4."""
    gen = torch.Generator(device=cuda).manual_seed(D + 13)
    for g in (1, 2, 4, 8):
        for qk_std in (0.5, 2 ** 0.5):
            Lk = 136 if g == 2 else 200
            q, k, v = (std * torch.randn((2, h, n, D), generator=gen,
                                         device=cuda)
                       for std, h, n in ((qk_std, 2 * g, 200),
                                         (qk_std, 2, Lk), (0.5, 2, Lk)))
            (o, lse), ran = _launches(lambda: K.flash_attention(
                q, k, v, None, causal, window, softcap, return_lse=True))
            torch.cuda.synchronize()
            assert ran == {n: int(n == "flash_attention_f32tc") for n in ran}
            ro, rlse = flash_attention_ref(q, k, v, None, causal, window,
                                           softcap)
            assert o.dtype == torch.float32 and o.shape == q.shape
            torch.testing.assert_close(o, ro, rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)


def test_f32_gradients_run_the_f32tc_forward_and_backward(cuda):
    """f32 ``flash_attention`` with its gradients (gemma2-2b's masks at
    head_dim 256, ragged L 130, GQA 8:4, strided views): the forward on the
    3xTF32 kernel, the backward on the 3xTF32 dq and dkv reading its LSE,
    no other flash kernel; the gradients within the reference's (rtol
    1e-3, atol 1e-4) of autograd through the plain forward."""
    gen = torch.Generator(device=cuda).manual_seed(2560)
    q, k, v = ((std * torch.randn((2, 130, h, 256), generator=gen,
                                  device=cuda)).transpose(1, 2)
               .requires_grad_()
               for std, h in ((2 ** 0.5, 8), (2 ** 0.5, 4), (0.5, 4)))
    do = 0.5 * torch.randn((2, 8, 130, 256), generator=gen, device=cuda)
    got, ran = _launches(lambda: torch.autograd.grad(
        K.flash_attention(q, k, v, None, True, 4096, 50.0), (q, k, v), do))
    want = {n: 0 for n in ran}
    want.update(flash_attention_f32tc=1, flash_attention_dq_f32tc=1,
                flash_attention_dkv_f32tc=1)
    assert ran == want
    ref = torch.autograd.grad(flash_attention_ref(q, k, v, None, True, 4096,
                                                  50.0)[0], (q, k, v), do)
    for g, w in zip(got, ref):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


def test_flash_simt_route_takes_bf16_when_named(cuda):
    """The wrapper's module-private launcher runs the f32 CUDA-core
    forward on bf16 inputs when the route is named, counted on that
    route; it agrees with the sm90 kernel to one bf16 step."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, h, 130, 128), generator=gen, device=cuda)
               .bfloat16() for h in (8, 2, 2))
    (simt, _), ran = _launches(lambda: FA._launch(
        q, k, v, 128 ** -0.5, True, None, None, route="simt"))
    assert _routes(ran) == {"sm90": 0, "f32tc": 0, "simt": 1}
    sm90 = K.flash_attention(q, k, v)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q, k, v)[0].float()
    for got in (simt, sm90):
        torch.testing.assert_close(got.float(), ref, rtol=2 ** -7, atol=1e-5)


def test_flash_kernel_reads_strided_views(cuda):
    """Attention hands the kernel (B, H, L, D) views of (B, L, H, D)
    projections: read in place, the same result as contiguous inputs."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn((2, 100, h, 64), generator=gen, device=cuda)
               .bfloat16().transpose(1, 2) for h in (8, 2, 2))
    got = K.flash_attention(q, k, v)
    want = K.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v)[0].float(),
                               rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("D", [16, 48, 128, 256])
@pytest.mark.parametrize("causal,window,softcap",
                         [(True, None, None), (False, None, None),
                          (True, 48, None), (False, 48, 30.0)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, D, causal, window,
                                       softcap):
    """The CUDA-core backward kernels (``csrc/flash_bwd.cu``, the route
    named, so f32, whose own route is f32tc, and bf16 run them): dQ and
    the per-q-head dK,
    dV against their plain versions on the same inputs: f32 at the
    reference's gradient tolerance (rtol 1e-3, atol 1e-4); bf16 dQ within
    one bf16 step (both round one f32 sum: rtol 2^-7, atol 1e-4), dK and
    dV f32 in both.  Ragged lengths (150, Lk 100), GQA 4, a padded head dim
    (48), q and k of std sqrt(2); one launch of each on the simt route."""
    gen = torch.Generator(device=cuda).manual_seed(D + 1)
    B, Hq, Hkv, L, Lk = 2, 8, 2, 150, 100
    q, k, v, do = (std * torch.randn((B, h, n, D), generator=gen,
                                     device=cuda)
                   for std, h, n in ((2 ** 0.5, Hq, L), (2 ** 0.5, Hkv, Lk),
                                     (0.5, Hkv, Lk), (0.5, Hq, L)))
    q, k, v, do = (x.to(dtype) for x in (q, k, v, do))
    scale = D ** -0.5
    o, lse = flash_attention_ref(q, k, v, scale, causal, window, softcap)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal, window, softcap)
    (dq, dk, dv), ran = _launches(lambda: _bwd_on_route(args, "simt"))
    torch.cuda.synchronize()
    assert _bwd_routes(ran) == {"sm90": (0, 0), "f32tc": (0, 0),
                                "simt": (1, 1)}
    rdk, rdv = flash_attention_dkv_ref(*args)
    f32 = dict(rtol=1e-3, atol=1e-4)
    assert dq.dtype == dtype and dk.dtype == dv.dtype == torch.float32
    torch.testing.assert_close(
        dq.float(), flash_attention_dq_ref(*args).float(),
        **(f32 if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-4)))
    torch.testing.assert_close(dk, rdk, **f32)
    torch.testing.assert_close(dv, rdv, **f32)


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 136, 200, 256])
@pytest.mark.parametrize("causal,window,softcap", MASKS)
@pytest.mark.parametrize("g,strided", [(1, False), (2, True), (4, True)],
                         ids=["mha", "gqa2_strided", "gqa4_strided"])
def test_flash_f32tc_bwd_kernels_match_plain(cuda, D, causal, window,
                                             softcap, g, strided):
    """The 3xTF32 backward kernels (``csrc/flash_bwd_f32tc.cu``; f32, every
    width they are built for, with 136 and 200 zero-padded to 256; the
    five masks) against their plain versions, dQ and the per-q-head dK, dV
    within the reference's gradient tolerance (``BWD_TOL["float32"]``: rtol
    1e-3, atol 1e-4).  Ragged Lq 150 and Lk 100 (no multiple of the 64-row
    CTA tiles or the 32- and 16-row k and q tiles), GQA groups of 1, 2 and
    4, q and k of std sqrt(2), and q, k, v, dO as (B, H, L, D) views of
    (B, L, H, D) tensors read in place; the wrappers' calls counted once
    each on the f32tc route and on no other."""
    gen = torch.Generator(device=cuda).manual_seed(D + 17 * g)
    B, Hkv, L, Lk = 2, 2, 150, 100
    Hq = g * Hkv
    shapes = ((2 ** 0.5, Hq, L), (2 ** 0.5, Hkv, Lk), (0.5, Hkv, Lk),
              (0.5, Hq, L))
    if strided:
        q, k, v, do = ((std * torch.randn((B, n, h, D), generator=gen,
                                          device=cuda)).transpose(1, 2)
                       for std, h, n in shapes)
    else:
        q, k, v, do = (std * torch.randn((B, h, n, D), generator=gen,
                                         device=cuda)
                       for std, h, n in shapes)
    scale = D ** -0.5
    o, lse = flash_attention_ref(q, k, v, scale, causal, window, softcap)
    delta = (do * o).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal, window, softcap)
    (dq, (dk, dv)), ran = _launches(
        lambda: (K.flash_attention_dq(*args), K.flash_attention_dkv(*args)))
    torch.cuda.synchronize()
    assert ran == {n: int(n in ("flash_attention_dq_f32tc",
                                "flash_attention_dkv_f32tc")) for n in ran}
    assert dq.dtype == dk.dtype == dv.dtype == torch.float32
    assert dq.shape == (B, Hq, L, D) and dk.shape == dv.shape == \
        (B, Hq, Lk, D)
    torch.testing.assert_close(dq, flash_attention_dq_ref(*args),
                               rtol=1e-3, atol=1e-4)
    rdk, rdv = flash_attention_dkv_ref(*args)
    torch.testing.assert_close(dk, rdk, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(dv, rdv, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128, 136, 200, 256])
@pytest.mark.parametrize("causal,window,softcap", MASKS)
@pytest.mark.parametrize("g,strided", [(1, False), (4, True)],
                         ids=["mha", "gqa4_strided"])
def test_flash_bwd_sm90_kernels_match_plain(cuda, D, causal, window, softcap,
                                            g, strided):
    """The sm90 backward kernels (bf16, every width they are built for:
    16, 32, 64, 80 and 128 on ``csrc/flash_bwd_sm90.cu``, 256 on
    ``csrc/flash_bwd_sm90_d256.cu``, with 136 and 200 zero-padded to it;
    the five masks) against their plain versions: dQ within one bf16 step
    (rtol 2^-7, atol 1e-4), the per-q-head dK, dV within the f32 gradient
    tolerance (rtol 1e-3, atol 1e-4).  Ragged Lq 150 and Lk 100 (no
    multiple of the 128-, 64- or 32-row tiles), GQA groups of 1 and of 4,
    and q, k, v, dO as (B, H, L, D) views of (B, L, H, D) tensors read in
    place; the wrappers' calls counted once each on the sm90 route, on its
    head_dim-256 kernels above 128."""
    gen = torch.Generator(device=cuda).manual_seed(D + 11 * g)
    B, Hkv, L, Lk = 2, 2, 150, 100
    Hq = g * Hkv
    shapes = ((2 ** 0.5, Hq, L), (2 ** 0.5, Hkv, Lk), (0.5, Hkv, Lk),
              (0.5, Hq, L))
    if strided:
        q, k, v, do = ((std * torch.randn((B, n, h, D), generator=gen,
                                          device=cuda))
                       .bfloat16().transpose(1, 2) for std, h, n in shapes)
    else:
        q, k, v, do = ((std * torch.randn((B, h, n, D), generator=gen,
                                          device=cuda)).bfloat16()
                       for std, h, n in shapes)
    scale = D ** -0.5
    o, lse = flash_attention_ref(q, k, v, scale, causal, window, softcap)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, scale, causal, window, softcap)
    (dq, (dk, dv)), ran = _launches(
        lambda: (K.flash_attention_dq(*args), K.flash_attention_dkv(*args)))
    torch.cuda.synchronize()
    assert _bwd_routes(ran) == {"sm90": (1, 1), "f32tc": (0, 0),
                                "simt": (0, 0)}
    assert ran["flash_attention_dq_d256"] == \
        ran["flash_attention_dkv_d256"] == int(D > 128)
    assert dq.dtype == torch.bfloat16 and dq.shape == (B, Hq, L, D)
    assert dk.shape == dv.shape == (B, Hq, Lk, D)
    torch.testing.assert_close(dq.float(),
                               flash_attention_dq_ref(*args).float(),
                               rtol=2 ** -7, atol=1e-4)
    rdk, rdv = flash_attention_dkv_ref(*args)
    torch.testing.assert_close(dk, rdk, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(dv, rdv, rtol=1e-3, atol=1e-4)


def test_flash_attention_grads_on_the_card(cuda):
    """``flash_attention``'s gradients (the forward and both backward
    kernels) against autograd through the plain forward, f32, on strided
    (B, H, L, D) views of (B, L, H, D) tensors and a strided output
    gradient."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn((2, 130, h, 64), generator=gen, device=cuda)
               .transpose(1, 2).requires_grad_() for h in (8, 2, 2))
    do = torch.randn((2, 130, 8, 64), generator=gen,
                     device=cuda).transpose(1, 2)
    got = torch.autograd.grad(K.flash_attention(q, k, v, None, True, 40),
                              (q, k, v), do)
    want = torch.autograd.grad(flash_attention_ref(q, k, v, None, True, 40
                                                   )[0], (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-4)


def test_bf16_d256_gradients_run_the_d256_sm90_backward(cuda):
    """bf16 at head_dim 256 under gemma2-2b's masks (causal, window 4096,
    softcap 50; ragged L 130, GQA 8:4): the forward runs the sm90 route's
    head_dim-256 kernel, the backward its head_dim-256 dq and dkv
    (``_route``), no other flash kernel runs, and the gradients
    match the plain backward on the same O and LSE: dQ, dK, dV each
    rounded once to bf16 in both (rtol 2^-7, atol 1e-4)."""
    gen = torch.Generator(device=cuda).manual_seed(256)
    q, k, v = ((std * torch.randn((2, 130, h, 256), generator=gen,
                                  device=cuda)).bfloat16().transpose(1, 2)
               .requires_grad_()
               for std, h in ((2 ** 0.5, 8), (2 ** 0.5, 4), (0.5, 4)))
    do = (0.5 * torch.randn((2, 8, 130, 256), generator=gen,
                            device=cuda)).bfloat16()

    def run():
        o, lse = K.flash_attention(q, k, v, None, True, 4096, 50.0,
                                   return_lse=True)
        return o, lse, torch.autograd.grad(o, (q, k, v), do)

    (o, lse, got), ran = _launches(run)
    assert ran == {"flash_attention": 0, "flash_attention_d256": 1,
                   "flash_attention_f32tc": 0,
                   "flash_attention_simt": 0, "flash_attention_dq": 0,
                   "flash_attention_dq_d256": 1,
                   "flash_attention_dq_f32tc": 0,
                   "flash_attention_dq_simt": 0, "flash_attention_dkv": 0,
                   "flash_attention_dkv_d256": 1,
                   "flash_attention_dkv_f32tc": 0,
                   "flash_attention_dkv_simt": 0}
    want = FA.flash_attention_bwd(*(x.detach().cpu() for x in (q, k, v, o,
                                                              lse, do)),
                                  256 ** -0.5, True, 4096, 50.0)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g.float().cpu(), w.float(),
                                   rtol=2 ** -7, atol=1e-4)


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 16),
                                     (torch.bfloat16, 256),
                                     (torch.float32, 16)],
                         ids=["sm90", "sm90_d256", "f32tc"])
def test_flash_kernels_take_65536_batch_heads(cuda, dtype, D):
    """B*Hq = 65536, one past a grid's y extent: q (4096, 16, 8, D), k and
    v (4096, 2, 8, D), causal.  The forward and the backward (sm90 route
    for bf16, at D 16 and on its head_dim-256 kernels; for f32 the 3xTF32
    forward and backward) against their plain versions
    within the tolerances of the tests above."""
    gen = torch.Generator(device=cuda).manual_seed(65536 + D)
    q, k, v, do = ((std * torch.randn(shape, generator=gen, device=cuda))
                   .to(dtype) for std, shape in (
                       (2 ** 0.5, (4096, 16, 8, D)),
                       (2 ** 0.5, (4096, 2, 8, D)), (0.5, (4096, 2, 8, D)),
                       (0.5, (4096, 16, 8, D))))
    bf16 = dtype == torch.bfloat16
    (o, lse), ran = _launches(lambda: K.flash_attention(
        q, k, v, return_lse=True))
    assert _routes(ran) == {"sm90": int(bf16), "f32tc": int(not bf16),
                            "simt": 0}
    assert ran["flash_attention_d256"] == int(D > 128)
    ro, rlse = flash_attention_ref(q, k, v)
    torch.testing.assert_close(o.float(), ro.float(),
                               **(dict(rtol=2 ** -7, atol=1e-5) if bf16
                                  else dict(rtol=1e-4, atol=1e-5)))
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    scale = D ** -0.5
    delta = (do.float() * ro.float()).sum(-1)
    args = (q, k, v, do, rlse, delta, scale, True, None, None)
    (dq, (dk, dv)), ran = _launches(
        lambda: (K.flash_attention_dq(*args), K.flash_attention_dkv(*args)))
    route = FA._route(dtype, D, "bwd")
    assert _bwd_routes(ran) == {r: (int(r == route),) * 2
                                for r in BWD_ROUTES}
    assert ran["flash_attention_dq_d256"] == \
        ran["flash_attention_dkv_d256"] == int(D > 128)
    f32 = dict(rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(
        dq.float(), flash_attention_dq_ref(*args).float(),
        **(dict(rtol=2 ** -7, atol=1e-4) if bf16 else f32))
    rdk, rdv = flash_attention_dkv_ref(*args)
    torch.testing.assert_close(dk, rdk, **f32)
    torch.testing.assert_close(dv, rdv, **f32)


@pytest.mark.parametrize("dtype,D,long_q,long_k",
                         [(torch.bfloat16, 16, (1 << 23) + 100, 1 << 23),
                          (torch.bfloat16, 256, (1 << 23) + 100, 1 << 22),
                          (torch.float32, 16, (1 << 23) + 100, 1 << 22)],
                         ids=["sm90", "sm90_d256", "f32tc"])
def test_flash_kernels_fold_long_sequences_into_grid_z(cuda, dtype, D,
                                                       long_q, long_k):
    """More tiles than a grid's y extent (65,535) holds: each kernel's tile
    rows times 65,536 or more.  A long Lq for the forward and dQ (sm90,
    head_dim-256 and 3xTF32 forward tiles of 128 rows, 3xTF32 dQ ones of
    64), a long Lk for dK, dV (sm90 tiles of 128 rows, head_dim-256 and
    3xTF32 ones of 64),
    against 16 keys or queries, non-causal.  Each output row depends on its
    own row and the short side alone, so the plain versions check the first
    and last 256 rows, the last ones in grid z's second slice, within the
    tolerances of the tests above."""
    gen = torch.Generator(device=cuda).manual_seed(D + long_q)
    bf16 = dtype == torch.bfloat16
    o_tol = dict(rtol=2 ** -7, atol=1e-5) if bf16 else \
        dict(rtol=1e-4, atol=1e-5)
    dq_tol = dict(rtol=2 ** -7, atol=1e-4) if bf16 else \
        dict(rtol=1e-3, atol=1e-4)
    rows = torch.cat([torch.arange(256), torch.arange(long_q - 256, long_q)]
                     ).to(cuda)

    def draw(L, std):
        return (std * torch.randn((1, 1, L, D), generator=gen,
                                  device=cuda)).to(dtype)

    q, do = draw(long_q, 2 ** 0.5), draw(long_q, 0.5)
    k, v = draw(16, 2 ** 0.5), draw(16, 0.5)
    o, lse = K.flash_attention(q, k, v, None, False, return_lse=True)
    ro, rlse = flash_attention_ref(q[:, :, rows], k, v, None, False)
    torch.testing.assert_close(o[:, :, rows].float(), ro.float(), **o_tol)
    torch.testing.assert_close(lse[:, :, rows], rlse, rtol=1e-4, atol=1e-4)
    scale = D ** -0.5
    delta = (do.float() * o.float()).sum(-1)
    dq = K.flash_attention_dq(q, k, v, do, lse, delta, scale, False)
    want = flash_attention_dq_ref(q[:, :, rows], k, v, do[:, :, rows],
                                  lse[:, :, rows], delta[:, :, rows], scale,
                                  False)
    torch.testing.assert_close(dq[:, :, rows].float(), want.float(),
                               **dq_tol)
    del q, do, o, lse, delta, dq

    rows = torch.cat([torch.arange(256), torch.arange(long_k - 256, long_k)]
                     ).to(cuda)
    q, do = draw(16, 2 ** 0.5), draw(16, 0.5)
    k, v = draw(long_k, 2 ** 0.5), draw(long_k, 0.5)
    o, lse = flash_attention_ref(q, k, v, scale, False)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = K.flash_attention_dkv(q, k, v, do, lse, delta, scale, False)
    rdk, rdv = flash_attention_dkv_ref(q, k[:, :, rows], v[:, :, rows], do,
                                       lse, delta, scale, False)
    torch.testing.assert_close(dk[:, :, rows], rdk, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(dv[:, :, rows], rdv, rtol=1e-3, atol=1e-4)


def test_training_step_through_the_kernels(cuda):
    """One AdamW step of the qwen2.5-3b smoke config on the card with the
    flash route on under ``remat="dots"``: one sm90 dQ and one sm90 dK/dV
    launch per layer, the sm90 forward twice per layer (again in the
    recompute), none on the CUDA-core routes, and finite metrics."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    from repro_torch.train import OptimizerConfig, adamw_init, \
        make_train_step
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), flash=True,
                              flash_block=16, remat="dots")
    model = LM(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 33), device=cuda)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    K.reset_launch_counts()
    _, _, met = make_train_step(model, OptimizerConfig())(
        params, adamw_init(params), batch)
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    counts = K.launch_counts()
    assert counts["flash_attention_dq"] == counts["flash_attention_dkv"] \
        == cfg.n_layers
    assert counts["flash_attention"] == 2 * cfg.n_layers
    assert counts["flash_attention_f32tc"] == 0
    assert counts["flash_attention_simt"] == 0
    assert counts["flash_attention_dq_simt"] == 0
    assert counts["flash_attention_dkv_simt"] == 0
