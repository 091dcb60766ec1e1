"""The CUDA kernels on the card: each against its plain version (the
copies bit-exact, flash attention and its backward within the reference's
own f32 tolerances), and the slices end to end through them.  Marked ``cuda``; they
skip where there is no GPU (run them on one with
``python -m pytest -m cuda tests/test_torch_cuda.py``)."""

import importlib
import json

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


def _written_3d(cuda, d, engine="memmap"):
    shape = (32, 48, 40)
    blocks = tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, (8, 16, 10)), num_procs=6, seed=3)
    field = torch.randn(shape, generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    ds = Dataset.create(str(d), engine=engine, device=cuda)
    ds.write("E", tc.plan_layout("merged_process", blocks, num_procs=6,
                                 procs_per_node=2), np.float32,
             {b.block_id: field[b.slices()].contiguous() for b in blocks})
    ds.close()
    return shape, blocks, field


def test_reorganize_and_read_pattern_on_the_card(cuda, tmp_path):
    """A small ``reorganize`` on the card: one ``pack_rows`` launch a
    gather batch, the destination's files equal to the CPU run's; then
    each pattern's decomposed read, one launch, with the CPU run's counts
    and the source's data."""
    from repro_torch.io import reorganize
    from repro_torch.io.device import gather_batches
    src = tmp_path / "src"
    shape, blocks, field = _written_3d(cuda, src)
    target = tc.plan_reorganization(blocks, shape, None, num_stagers=3)
    files, stats = {}, {}
    for dev in ("cuda", "cpu"):
        d = tmp_path / dev
        K.reset_launch_counts()
        _, dst, _ = reorganize(str(src), str(d), "E", target, device=dev)
        assert K.launch_counts()["pack_rows"] == (
            len(gather_batches([cp.chunk.volume * 4 for cp in
                                target.chunks])) if dev == "cuda" else 0)
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


@pytest.mark.parametrize("engine", ["odirect", "uring"])
def test_kernel_bypass_read_back_onto_the_card(cuda, tmp_path, engine):
    """A 3-D field written under ``merged_process`` with a kernel-bypass
    engine and read back whole onto the card through it: one ``pack_rows``
    launch, the source's values; the engine that ran is the one asked for
    unless the host's probe refuses it, and then the reason says why."""
    from repro_torch.io.direct import odirect_available
    from repro_torch.io.uring import uring_available
    d = tmp_path / "d"
    shape, _, field = _written_3d(cuda, d, engine)
    ok, why = uring_available() if engine == "uring" else \
        odirect_available(str(d))
    ds = Dataset.open(str(d), engine=engine, device=cuda)
    K.reset_launch_counts()
    got, st = ds.read("E", Block((0, 0, 0), shape))
    assert K.launch_counts()["pack_rows"] == 1
    assert torch.equal(got, field)
    if ok:
        assert (st.engine, st.engine_reason) == (engine, "pinned")
    else:
        assert st.engine == {"uring": "overlapped", "odirect": "pread"}[
            engine] and why in st.engine_reason
    ds.close()


def test_distributed_reorganize_on_the_card(cuda, tmp_path):
    """Two worker processes gathering on the card (``device="cuda"``,
    O_DIRECT writes): subfiles and ``index.json`` chunks equal to a
    single-process ``reorganize`` of the same source, and the committed
    dataset read back onto the card equal to the field."""
    from repro_torch.distributed import distributed_reorganize
    from repro_torch.io import reorganize
    src = tmp_path / "src"
    shape, blocks, field = _written_3d(cuda, src)
    target = tc.plan_reorganization(blocks, shape, None, num_stagers=3)
    _, ref, _ = reorganize(str(src), str(tmp_path / "ref"), "E", target,
                           device=cuda)
    ref.close()
    dst = tmp_path / "dst"
    ds, stats = distributed_reorganize(str(src), str(dst), "E", target,
                                       num_workers=2, engine="odirect",
                                       round_timeout_s=300.0, device="cuda")
    got, _ = ds.read("E", Block((0, 0, 0), shape))
    ds.close()
    assert torch.equal(got, field)
    assert (stats["rounds"], stats["validation_failures"]) == (1, 0)
    bins = sorted(f.name for f in dst.glob("data_*.bin"))
    assert bins == sorted(f.name for f in (tmp_path / "ref").glob(
        "data_*.bin"))
    for f in bins:
        assert (dst / f).read_bytes() == (tmp_path / "ref" / f).read_bytes()
    chunks = [json.loads((p / "index.json").read_text())["chunks"]
              for p in (dst, tmp_path / "ref")]
    assert chunks[0] == chunks[1]


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


def _served_world(tmp_path, cuda):
    """A raw 3-D field (``merged_process`` over load-balanced boxes) and
    the same field compressed, written from tensors on the card."""
    shape = (40, 48, 36)
    blocks = tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, (10, 12, 9)), num_procs=6, seed=2)
    field = torch.randn(shape, generator=torch.Generator(
        device=cuda).manual_seed(3), device=cuda)
    ds = Dataset.create(str(tmp_path), engine="pread", device=cuda)
    layout = tc.plan_layout("merged_process", blocks, num_procs=6)
    data = {b.block_id: field[b.slices()] for b in blocks}
    ds.write("E", layout, np.float32, data)
    ds.write("Z", layout, np.float32, data, codec="zlib")
    ds.close()
    return field


SERVED = [Block((0, 0, 0), (20, 48, 36)), Block((10, 5, 0), (30, 40, 36)),
          Block((0, 24, 18), (40, 25, 19)), Block((39, 0, 0), (40, 48, 36))]


def test_read_super_planned_on_the_card(cuda, tmp_path):
    """One super-plan of raw chunks: ONE ``pack_rows`` launch gathers
    every member on the card, each equal to the CPU route's bytes and to
    the field; compressed members take the host scatter (no launch)."""
    from repro_torch.serve import build_super_plan
    field = _served_world(tmp_path, cuda)
    gpu = Dataset.open(str(tmp_path), engine="pread", device=cuda)
    cpu = Dataset.open(str(tmp_path), engine="pread", device="cpu")
    for var, launches, route in (("E", 1, "device"), ("Z", 0, "host")):
        sp = build_super_plan(gpu.index, var, SERVED)
        K.reset_launch_counts()
        outs, fstats, members = gpu.read_super_planned(sp)
        assert K.launch_counts()["pack_rows"] == launches
        assert fstats.bytes_read == sp.fetch_bytes
        want, _, _ = cpu.read_super_planned(sp)
        for r, got, w, st in zip(SERVED, outs, want, members):
            assert got.device == cuda and st.route == route
            assert torch.equal(got.cpu(), w)
            assert torch.equal(got, field[r.slices()])
    gpu.close()
    cpu.close()


def test_read_super_planned_gathers_misaligned_spans_on_the_card(
        cuda, tmp_path):
    """A raw extent that follows an odd-sized compressed one in the same
    merged span starts off an element of the fetch buffer: ONE
    ``pack_rows`` launch over bytes still gathers its member on the card,
    and the compressed member takes the host scatter."""
    from repro_torch.io.replay import _identity_layout
    from repro_torch.serve import build_super_plan
    field = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (48, 48)).astype(np.float32)).to(cuda)
    ds = Dataset.create(str(tmp_path), engine="pread", device=cuda)
    for chunks, codec in (([[[0, 0], [24, 48], 0]], "zlib"),
                          ([[[24, 0], [48, 48], 0]], "none")):
        layout = _identity_layout(chunks, (48, 48))
        ds.write("N", layout, np.float32,
                 {cp.chunk.block_id: field[cp.chunk.slices()]
                  for cp in layout.chunks}, codec=codec)
    assert [r.nbytes % 4 for r in ds.index.chunks][0], \
        "the compressed extent must have an odd size"
    ds.close()
    ds = Dataset.open(str(tmp_path), engine="pread", device=cuda)
    regions = [Block((30, 0), (48, 48)), Block((0, 0), (48, 48))]
    sp = build_super_plan(ds.index, "N", regions)
    K.reset_launch_counts()
    outs, fstats, members = ds.read_super_planned(sp)
    assert K.launch_counts()["pack_rows"] == 1
    assert fstats.bytes_read == sp.fetch_bytes
    assert [m.route for m in members] == ["device", "host"]
    for r, got in zip(regions, outs):
        assert got.device == cuda and torch.equal(got, field[r.slices()])
    ds.close()


def test_read_service_on_the_card(cuda, tmp_path):
    """Eight client threads submit at once: the service gathers each
    coalesced batch with one ``pack_rows`` launch (launches ==
    ``super_plans``), and every future's tensor is complete when it
    resolves — a client reads it on its own stream at once."""
    import threading
    from repro_torch.serve import ReadService
    field = _served_world(tmp_path, cuda)
    ds = Dataset.open(str(tmp_path), engine="pread", device=cuda)
    results, errors = {}, []
    K.reset_launch_counts()
    with ReadService(ds, window_s=0.05) as svc:
        def client(t):
            try:
                stream = torch.cuda.Stream(cuda)
                futs = [svc.submit(f"t{t}", "E", r) for r in SERVED]
                for i, f in enumerate(futs):
                    got, st = f.result(timeout=120)
                    with torch.cuda.stream(stream):
                        results[t, i] = got.clone()
                    stream.synchronize()
            except Exception as exc:          # noqa: BLE001 — reported below
                errors.append(exc)
        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
    assert not errors and len(results) == 8 * len(SERVED)
    assert K.launch_counts()["pack_rows"] == svc.stats.super_plans >= 1
    assert svc.stats.requests == 8 * len(SERVED)
    for (t, i), got in results.items():
        assert torch.equal(got, field[SERVED[i].slices()])
    ds.close()


@pytest.mark.parametrize("name", ["dims_small", "serve_paged_small",
                                  "restore_storm_small"])
def test_replayed_trace_on_the_card_gives_the_cpu_digest(cuda, tmp_path,
                                                        name):
    """A committed trace replayed on the card and on the CPU: one digest,
    the copy kernels launched on the card."""
    import os
    from repro_torch.io import load_trace, replay_trace
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "traces", f"{name}.jsonl")
    K.reset_launch_counts()
    on_card = replay_trace(load_trace(path), str(tmp_path / "card"),
                           device=cuda)
    assert K.launch_counts()["pack_rows"] > 0
    on_cpu = replay_trace(load_trace(path), str(tmp_path / "cpu"),
                          device="cpu")
    assert (on_card.digest, on_card.counts, on_card.bytes_verified,
            on_card.decisions) == (on_cpu.digest, on_cpu.counts,
                                   on_cpu.bytes_verified, on_cpu.decisions)


# -- bf16 container variables, the SSD and hybrid blocks ------------------------

@pytest.mark.parametrize("strategy", ["merged_process", "reorganized"])
def test_bf16_dataset_on_the_card(cuda, tmp_path, strategy):
    """bf16 blocks on the card written through the device route and read
    back whole (linearized) and in part (the region route): ``torch.equal``
    to the source, the stored dtype ``"bfloat16"``."""
    x = torch.randn(256, 384, device=cuda).to(torch.bfloat16)
    blocks = tc.simulate_load_balance(tc.uniform_grid_blocks((256, 384),
                                                             (64, 96)),
                                      num_procs=6, seed=0)
    lay = tc.plan_layout(strategy, blocks, num_procs=6, procs_per_node=2,
                         global_shape=(256, 384), reorg_scheme=(4, 4))
    ds = Dataset.create(str(tmp_path), device=cuda)
    before = K.pack_rows.launches
    ds.write("K", lay, torch.bfloat16,
             {b.block_id: x[b.slices()] for b in blocks})
    ds.close()
    ds = Dataset.open(str(tmp_path), device=cuda)
    assert ds.index.variables["K"]["dtype"] == "bfloat16"
    got, _ = ds.read("K", Block((0, 0), (256, 384)))
    part, _ = ds.read("K", Block((17, 30), (200, 333)))
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.device.type == "cuda"
    assert torch.equal(got, x) and torch.equal(part, x[17:200, 30:333])
    assert K.pack_rows.launches > before
    ds.close()


def _ssm_block(arch, kind, cuda):
    """One block of ``arch``'s smoke config with seeded weights, on the CPU
    and on the card (the same values)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import materialize, tree_map
    cfg = dataclasses.replace(get_smoke_config(arch), flash=True,
                              flash_block=16)
    p = materialize(tfm.block_defs(cfg, kind), torch.Generator()
                    .manual_seed(0))
    return cfg, p, tree_map(lambda t: t.to(cuda), p)


@pytest.mark.parametrize("arch,kind", [("mamba2-780m", "ssd"),
                                       ("hymba-1.5b", "hyb_full"),
                                       ("hymba-1.5b", "hyb_swa")])
def test_ssd_and_hybrid_blocks_on_the_card(cuda, arch, kind):
    """An SSD block and the hybrid blocks (flash route on) in f32 on the
    card against their CPU run: the forward, the prefill cache and one
    decode step written into it (rtol 1e-3, atol 1e-4: the card's f32
    products sum in another order, and the hybrid's attention runs the
    3xTF32 kernel, held to its plain version at 1e-4 itself)."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import flatten_cache
    cfg, p_cpu, p_gpu = _ssm_block(arch, kind, cuda)
    x = torch.randn(2, 32, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1)) * 0.5
    x1 = torch.randn(2, 1, cfg.d_model, generator=torch.Generator()
                     .manual_seed(2)) * 0.5
    saved, layers._COMPUTE = layers._COMPUTE, torch.float32
    try:
        outs = {}
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            pos = torch.arange(32, device=dev)
            y, _, kv = tfm.block_forward(cfg, kind, p, x.to(dev), pos,
                                         collect_kv=True)
            defs = tfm.block_cache_defs(cfg, kind, 2, 40)
            cache = tfm.block_prefill(cfg, kind, kv, defs, 2, 32)
            y1, cache = tfm.block_decode(cfg, kind, p, x1.to(dev), cache, 32)
            outs[dev] = (y, y1, flatten_cache(cache))
    finally:
        layers._COMPUTE = saved
    tol = dict(rtol=1e-3, atol=1e-4)
    for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
        torch.testing.assert_close(a.cpu(), b, **tol)
    for name, b in outs["cpu"][2].items():
        a = outs["cuda"][2][name]
        assert a.dtype == b.dtype and a.device.type == "cuda"
        if b.dtype == torch.bfloat16:       # one bf16 step of the f32 gap
            torch.testing.assert_close(a.cpu().float(), b.float(),
                                       rtol=2 ** -7, atol=1e-4)
        else:
            torch.testing.assert_close(a.cpu(), b, **tol)


def test_gather_to_nodes_on_the_card(cuda):
    """Leaders' blocks pass through, every other block is a copy on the
    card with its bytes."""
    from repro_torch.io import gather_to_nodes
    blocks = tc.simulate_load_balance(tc.uniform_grid_blocks((128, 128),
                                                             (32, 32)),
                                      num_procs=6, seed=1)
    x = torch.randn(128, 128, device=cuda)
    data = {b.block_id: x[b.slices()] for b in blocks}
    node_blocks, out, seconds = gather_to_nodes(blocks, data, 2)
    assert seconds > 0
    for b, nb in zip(blocks, node_blocks):
        assert nb.owner == b.owner // 2
        t = out[b.block_id]
        assert t.device.type == "cuda" and torch.equal(t, data[b.block_id])
        assert (t is data[b.block_id]) == (b.owner % 2 == 0)


def test_flash_sm90_forward_at_hymbas_shape(cuda):
    """The sm90 forward at hymba-1.5b's serving shape: B 4, 25 q-heads over
    5 kv-heads (GQA groups of 5, B·Hq 100), L 2048, D 64, causal with a
    window of 1024; bf16 O within one bf16 step of the plain version, LSE
    within 1e-4, one launch on the sm90 route's head_dim-128 kernel."""
    gen = torch.Generator(device=cuda).manual_seed(25)
    q, k, v = (std * torch.randn((4, h, 2048, 64), generator=gen,
                                 device=cuda)
               for std, h in ((2 ** 0.5, 25), (2 ** 0.5, 5), (0.5, 5)))
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2).to(
        torch.bfloat16) for t in (q, k, v))
    (o, lse), ran = _launches(lambda: K.flash_attention(
        q, k, v, None, True, 1024, None, return_lse=True))
    torch.cuda.synchronize()
    assert ran["flash_attention"] == 1 and sum(ran.values()) == 1
    ro, rlse = flash_attention_ref(q, k, v, None, True, 1024, None)
    torch.testing.assert_close(o.float(), ro.float(), rtol=2 ** -7,
                               atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)


def _grads_on(dev, fn, params, *inputs):
    """``fn(params, *inputs)``'s output and the gradients of its sum
    against a seeded cotangent with respect to every param, on ``dev``."""
    from repro_torch.models.params import tree_leaves, tree_map
    p = tree_map(lambda t: t.to(dev).requires_grad_(), params)
    out, *rest = fn(p, *(t.to(dev) for t in inputs))
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(3))
    loss = (out * ct.to(dev)).sum() + sum(r.sum() for r in rest)
    leaves = tree_leaves(p)
    return [out, *rest], torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("case", ["moe_block", "ssd_chunk_256"])
def test_moe_block_and_ssd_backward_on_the_card(cuda, case, monkeypatch):
    """Gradients on the card against the CPU run of the same weights, f32
    compute.  ``moe_block``: one deepseek-moe-16b smoke ``moe`` block
    (flash route on: the 3xTF32 forward and backward; the router, the
    dispatch scatter-add and the combine gather), its output, aux loss
    and every gradient (rtol 1e-3, atol 1e-4), the experts the router
    picks from its own input (``ln2`` of x plus attention) equal on both
    devices.  ``ssd_chunk_256``: the SSD fault's input
    (``tests/test_torch_ssm.py``: one chunk of 256 whose decay overflows
    above the diagonal), every gradient finite on the card and equal to
    the CPU's to the same tolerance."""
    from repro_torch.models import layers
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.models.params import materialize
    gen = torch.Generator().manual_seed(0)
    picks = []
    if case == "moe_block":
        cfg, params, _ = _ssm_block("deepseek-moe-16b", "moe", cuda)
        # attention at true fan-in: under the reference's init most score
        # rows are an argmax, and the two devices' f32 rounding flips
        # near-ties (tests/test_torch_train.py's ``_fan_in``)
        a = params["attn"]
        for name, scale in (("wq", cfg.n_heads / cfg.d_model),
                            ("wk", cfg.n_kv / cfg.d_model),
                            ("wv", cfg.n_kv / cfg.d_model),
                            ("wo", 1 / cfg.n_heads)):
            a[name] = a[name] * scale ** 0.5
        x = torch.randn(2, 32, cfg.d_model, generator=gen) * 0.5
        pos = torch.arange(32)

        def fn(p, h, ps):
            y, aux, _ = tfm.block_forward(cfg, "moe", p, h, ps)
            return y, aux
        inputs = (x, pos)
        route = moe_mod._route

        def spy(p, xf, dims):
            out = route(p, xf, dims)
            picks.append(out[1].cpu())
            return out
        monkeypatch.setattr(moe_mod, "_route", spy)
    else:
        dims = ssm.SSMDims(d_model=8, d_inner=16, headdim=8, d_state=4)
        params = materialize(ssm.ssd_defs(dims), gen)

        def fn(p, h):
            return (ssm.ssd_forward(p, h, dims, chunk=256),)
        inputs = (torch.randn(1, 256, 8, generator=gen),)
    saved, layers._COMPUTE = layers._COMPUTE, torch.float32
    try:
        outs_cpu, g_cpu = _grads_on("cpu", fn, params, *inputs)
        outs_gpu, g_gpu = _grads_on(cuda, fn, params, *inputs)
    finally:
        layers._COMPUTE = saved
    if case == "moe_block":     # one routing a run: the CPU's, the card's
        assert len(picks) == 2 and torch.equal(*picks)
    tol = dict(rtol=1e-3, atol=1e-4)
    for a, b in zip(outs_gpu, outs_cpu):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), **tol)
    for a, b in zip(g_gpu, g_cpu):
        assert torch.isfinite(a).all() and a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, **tol)


def test_flash_sm90_kernels_at_huberts_training_shape(cuda):
    """The sm90 forward, dq and dkv at hubert-xlarge's training shape: B 2,
    16 heads over 16 (MHA), L 2048, D 80 (padded to 128 on the card),
    non-causal, as attention hands them over ((B, H, L, D) views of
    (B, L, H, D)); bf16 O and dQ within one bf16 step of the plain
    versions, the LSE within 1e-4, the f32 per-q-head dK, dV at the f32
    gradient tolerance (rtol 1e-3, atol 1e-4); one launch of each sm90
    head_dim-128 kernel and none other."""
    gen = torch.Generator(device=cuda).manual_seed(80)
    q, k, v, do = (std * torch.randn((2, 2048, 16, 80), generator=gen,
                                     device=cuda)
                   for std in (2 ** 0.5, 2 ** 0.5, 0.5, 0.5))
    q, k, v, do = (t.to(torch.bfloat16).transpose(1, 2)
                   for t in (q, k, v, do))
    (o, lse), ran = _launches(lambda: K.flash_attention(
        q, k, v, None, False, None, None, return_lse=True))
    assert ran["flash_attention"] == 1 and sum(ran.values()) == 1
    ro, rlse = flash_attention_ref(q, k, v, None, False, None, None)
    torch.testing.assert_close(o.float(), ro.float(), rtol=2 ** -7,
                               atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-4, atol=1e-4)
    scale = 80 ** -0.5
    delta = (do.float() * ro.float()).sum(-1)
    args = (q, k, v, do, rlse, delta, scale, False, None, None)
    (dq, (dk, dv)), ran = _launches(lambda: (K.flash_attention_dq(*args),
                                             K.flash_attention_dkv(*args)))
    assert ran["flash_attention_dq"] == ran["flash_attention_dkv"] == 1
    assert sum(ran.values()) == 2
    torch.cuda.synchronize()
    torch.testing.assert_close(dq.float(),
                               flash_attention_dq_ref(*args).float(),
                               rtol=2 ** -7, atol=1e-4)
    rdk, rdv = flash_attention_dkv_ref(*args)
    torch.testing.assert_close(dk, rdk, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(dv, rdv, rtol=1e-3, atol=1e-4)


def test_xattn_block_on_the_card(cuda):
    """One llama-3.2-vision-90b smoke ``xattn`` block with its gate at 0.7,
    in f32 compute over bf16 memory, on the card against its CPU run: the
    forward, the bf16 ``xk``/``xv`` cache (one bf16 step) and one decode
    step reading it (rtol 1e-3, atol 1e-4: the card's f32 products sum in
    another order)."""
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm
    cfg, p_cpu, p_gpu = _ssm_block("llama-3.2-vision-90b", "xattn", cuda)
    for p in (p_cpu, p_gpu):
        p["attn"]["gate"].fill_(0.7)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 32, cfg.d_model, generator=gen) * 0.5
    x1 = torch.randn(2, 1, cfg.d_model, generator=gen) * 0.5
    mem = (torch.randn(2, cfg.n_memory_tokens, cfg.d_model, generator=gen)
           * 0.5).to(torch.bfloat16)
    saved, layers._COMPUTE = layers._COMPUTE, torch.float32
    try:
        outs = {}
        for dev, p in (("cpu", p_cpu), ("cuda", p_gpu)):
            y, _, kv = tfm.block_forward(cfg, "xattn", p, x.to(dev),
                                         torch.arange(32, device=dev),
                                         mem.to(dev), collect_kv=True)
            defs = tfm.block_cache_defs(cfg, "xattn", 2, 40)
            cache = tfm.block_prefill(cfg, "xattn", kv, defs, 2, 32)
            y1, cache = tfm.block_decode(cfg, "xattn", p, x1.to(dev),
                                         cache, 32)
            outs[dev] = (y, y1, cache)
    finally:
        layers._COMPUTE = saved
    for a, b in zip(outs["cuda"][:2], outs["cpu"][:2]):
        assert a.device.type == "cuda" and a.dtype == torch.float32
        torch.testing.assert_close(a.cpu(), b, rtol=1e-3, atol=1e-4)
    for name in ("xk", "xv"):
        a, b = outs["cuda"][2][name], outs["cpu"][2][name]
        assert a.dtype == b.dtype == torch.bfloat16
        torch.testing.assert_close(a.cpu().float(), b.float(),
                                   rtol=2 ** -7, atol=1e-4)


def test_distributed_world_on_the_card(cuda):
    """The distributed slice in a 2-rank gloo world on the one card
    (``chip_smoke.distributed`` at the smoke config's width, both ranks on
    cuda:0): the sharded step against the unsharded one, the reduce-once
    step against its oracle, the compressed sum bit-equal to the CPU's and
    the sharded checkpoint restored equal, each rank's per-shard flash
    launches counted (``chip_smoke.py`` phase 26 at full width)."""
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke
    out = chip_smoke.distributed(torch, cuda, K, smoke=True)
    r0 = out["ranks"][0]
    assert r0["a"]["grad_gap_max"] < chip_smoke.DIST_GRAD_GAP
    assert r0["b"]["grad_gap_max"] < chip_smoke.DIST_GRAD_GAP
    assert r0["c"]["restored_equal"] and r0["c"]["pack_rows_save"] > 0


def test_zero1_and_remat_sharded_steps_on_the_card(cuda):
    """Phase 26's world at the smoke config's width on the card: 26a's
    sharded step under ``remat="dots"`` (gradients against the unsharded
    step's, the recompute's forward launches) and its bf16 step against
    the unsharded bf16 step, and 26b's ZeRO-1 update (``adamw_init(
    zero1=True)``) bit-equal to the replicated-moment one with half the
    moment bytes on each rank."""
    import pathlib
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke
    out = chip_smoke.distributed(torch, cuda, K, smoke=True)
    a = out["ranks"][0]["a"]
    assert a["remat"] == "dots"
    assert a["grad_gap_max"] < chip_smoke.DIST_GRAD_GAP
    assert a["bf16_step"]["loss_gap"] < chip_smoke.DIST_LOSS_GAP_BF16
    assert a["bf16_step"]["grad_gap_max"] < chip_smoke.GRAD_GAP_BF16
    for r in out["ranks"]:
        z = r["b"]["zero1"]
        assert z["params_bit_equal"]
        assert 2 * z["moment_bytes"] == z["replicated_moment_bytes"]


def test_generate_times_on_events_without_synchronize(cuda, monkeypatch):
    """``ServeEngine.generate`` times its prefill and decode steps with CUDA
    events read once the tokens reach the host: no
    ``torch.cuda.synchronize`` in the call, the same tokens as a call
    before, and both timings positive."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    from repro_torch.serve import ServeEngine
    cfg = get_smoke_config("hymba-1.5b")
    model = LM(cfg, device=cuda)
    engine = ServeEngine(model, model.init(torch.Generator(cuda).manual_seed(0)),
                         max_len=96, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, 64))
    want, _ = engine.generate(prompts, 8)

    def refuse(*args, **kwargs):
        raise AssertionError("generate synchronized the device")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    got, stats = engine.generate(prompts, 8)
    assert np.array_equal(got, want)
    assert stats.prefill_seconds > 0 and stats.decode_seconds > 0
    assert stats.tokens_generated == 4 * 8


def test_spans_on_the_backward_thread(cuda, tmp_path):
    """A MoE training step on the card under the profiler: the regions'
    backward spans open on autograd's device thread, nest there, and hold
    ``IndexPutBackward0``; each layer's recompute runs in its own span
    there, outside every region's backward span."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import LM
    from repro_torch.models.moe import MoEDims
    from repro_torch.models.transformer import ModelConfig
    from repro_torch.train import (OptimizerConfig, adamw_init,
                                   make_train_step)
    cfg = ModelConfig(
        name="moe-spans", family="moe", n_layers=3, d_model=64, n_heads=4,
        n_kv=4, head_dim=16, d_ff=96, vocab=64,
        program=(("attn", 1), ("moe", 2)),
        moe=MoEDims(d_model=64, d_ff=32, n_experts=8, top_k=3, n_shared=2),
        tie_embed=False, remat="dots", q_chunk=16, loss_chunk=16)
    model = LM(cfg, device=cuda)
    params = model.init(torch.Generator(cuda).manual_seed(0))
    step = make_train_step(model, OptimizerConfig())
    opt = adamw_init(params)
    g = torch.Generator(cuda).manual_seed(1)
    batch = {k: torch.randint(0, 64, (2, 32), generator=g, device=cuda)
             for k in ("tokens", "labels")}
    params, opt, _ = step(params, opt, batch)          # warm up
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(params, opt, batch)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [(e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0), e["name"])
          for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    opens = [e for e in ev if e[3] ==
             "autograd::engine::evaluate_function: _OutputsBackward"]
    ours = [e for e in ev if e[3].startswith("repro_torch.")]
    back = [e for e in ours if any(o[0] == e[0] and o[1] <= e[1] <= o[2]
                                   for o in opens)]
    fwd_tid = next(e[0] for e in ours if e[3] == "repro_torch.adamw")
    assert back and {e[0] for e in back} != {fwd_tid}
    for a in ours:
        for b in ev:
            if b[0] == a[0] and (a[1] < b[1] < a[2] < b[2]
                                 or b[1] < a[1] < b[2] < a[2]):
                assert "_OutputsBackward" in b[3] or \
                    "_InputsBackward" in b[3], (a, b)
    disp = [e for e in ours if e[3] == "repro_torch.moe.dispatch"]
    ipb = [e for e in ev if e[3] ==
           "autograd::engine::evaluate_function: IndexPutBackward0"]
    assert len(ipb) == 2 and all(
        any(d[0] == i[0] and d[1] <= i[1] and i[2] <= d[2] for d in disp)
        for i in ipb)
    rec = [e for e in ours if e[3] == "repro_torch.remat.recompute"]
    assert len(rec) == 2 and not any(
        r[0] == b[0] and r[1] < b[2] and b[1] < r[2] for r in rec
        for b in back)
