"""The port's kernel modules against the JAX package's, on the CPU: the
vectorized row-table lowering equals the reference lowering, and the plain
versions of the three copy kernels equal the Pallas kernels run in
interpret mode.  All comparisons are bit-exact: these are copies."""

import pathlib
import sys

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.core as jc
from repro.core.merge import execute_merge_numpy
from repro.kernels import (chunked_to_rowmajor as jax_c2r,
                           merge_blocks_device as jax_merge,
                           pack_rows as jax_pack_rows,
                           rowmajor_to_chunked as jax_r2c)
from repro.kernels.ref import plan_row_tables as jax_plan_row_tables

import repro_torch.core as tc
import repro_torch.kernels as K
from repro_torch.interop import blocks_from_records, to_numpy, to_tensor
from repro_torch.kernels.ref import plan_row_tables

DTYPES = [np.float32, ml_dtypes.bfloat16, np.int32, np.int8]


def _recs(blocks):
    return [(b.lo, b.hi, b.owner, b.block_id) for b in blocks]


def _assert_tables_equal(a, b):
    assert a[0] == b[0] and a[3] == b[3] and a[4] == b[4]
    assert a[1].dtype == b[1].dtype == np.int32
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[2], b[2])


def _owned_plans(shape, block, procs, seed):
    jb = jc.simulate_load_balance(jc.uniform_grid_blocks(shape, block),
                                  num_procs=procs, seed=seed)
    tb = blocks_from_records(_recs(jb))
    for p in range(procs):
        jm = [b for b in jb if b.owner == p]
        if jm:
            yield (jc.build_merge_plan(jm),
                   tc.build_merge_plan([b for b in tb if b.owner == p]))


# -- plan lowering -------------------------------------------------------------

@pytest.mark.parametrize("world", [((32, 32, 32), (8, 8, 8), 4, s)
                                   for s in range(4)]
                         + [((64, 32, 48), (16, 16, 16), 3, 1)],
                         ids=lambda w: f"{w[0]}-seed{w[3]}")
def test_plan_row_tables_reference_cases(world):
    for jp, tp in _owned_plans(*world):
        _assert_tables_equal(plan_row_tables(tp), jax_plan_row_tables(jp))


@st.composite
def lowering_cases(draw):
    ndim = draw(st.sampled_from([1, 2, 3]))
    block = [draw(st.sampled_from([1, 2, 3, 4, 6, 8])) for _ in range(ndim)]
    counts = [draw(st.integers(1, 4)) for _ in range(ndim)]
    shape = tuple(c * b for c, b in zip(counts, block))
    procs = draw(st.integers(1, 4))
    seed = draw(st.integers(0, 2 ** 16))
    max_width = draw(st.sampled_from([4096, 16, 5, 3, 1]))
    reverse = draw(st.booleans())
    return shape, tuple(block), procs, seed, max_width, reverse


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(lowering_cases())
def test_plan_row_tables_sweep(case):
    shape, block, procs, seed, max_width, reverse = case
    for jp, tp in _owned_plans(shape, block, procs, seed):
        order = sorted({op.block_id for op in jp.copies}, reverse=reverse)
        _assert_tables_equal(
            plan_row_tables(tp, block_order=order, max_width=max_width),
            jax_plan_row_tables(jp, block_order=order, max_width=max_width))


# -- the three kernels ---------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", [(32, 128), (64, 256), (16, 512)])
def test_pack_rows_matches_pallas(dtype, shape):
    rng = np.random.default_rng([*shape, np.dtype(dtype).num])
    n, w = shape
    src = rng.standard_normal((n, w)).astype(dtype)
    perm = rng.permutation(n).astype(np.int32)
    m = n + 8                     # 8 destination rows are named by no one
    dst_rows = rng.choice(m, size=n, replace=False).astype(np.int32)
    ref = jax_pack_rows(jnp.asarray(src), jnp.asarray(perm),
                        jnp.asarray(dst_rows), n_dst_rows=m, width=w,
                        interpret=True)
    got = K.pack_rows(to_tensor(src, "cpu"), torch.from_numpy(perm),
                      torch.from_numpy(dst_rows), n_dst_rows=m, width=w)
    np.testing.assert_array_equal(to_numpy(got, dtype), np.asarray(ref))
    unnamed = np.setdiff1d(np.arange(m), dst_rows)
    assert not to_numpy(got)[unnamed].any()


def test_pack_rows_2d_weight_shards():
    """The checkpoint-merge case: row-slab shards of a 2-D weight."""
    rng = np.random.default_rng(0)
    W = np.asarray(rng.standard_normal((64, 256)), np.float32)
    shard_rows = [(32, 48), (0, 16), (48, 64), (16, 32)]
    src = np.concatenate([W[a:b] for a, b in shard_rows])
    dst_rows = np.concatenate([np.arange(a, b) for a, b in shard_rows]) \
        .astype(np.int32)
    src_rows = np.arange(64, dtype=np.int32)
    ref = jax_pack_rows(jnp.asarray(src), jnp.asarray(src_rows),
                        jnp.asarray(dst_rows), n_dst_rows=64, width=256,
                        interpret=True)
    got = K.pack_rows(torch.from_numpy(src), torch.from_numpy(src_rows),
                      torch.from_numpy(dst_rows), n_dst_rows=64, width=256)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), W)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16],
                         ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("grid,chunk", [((4, 2), (8, 128)),
                                        ((2, 4), (16, 128)),
                                        ((3, 3), (8, 256))])
def test_relayout_matches_pallas(dtype, grid, chunk):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((*grid, *chunk)).astype(dtype)
    ref = jax_c2r(jnp.asarray(x), chunk=chunk, interpret=True)
    got = K.chunked_to_rowmajor(to_tensor(x, "cpu"), chunk=chunk)
    np.testing.assert_array_equal(to_numpy(got, dtype), np.asarray(ref))
    back_ref = jax_r2c(ref, chunk=chunk, interpret=True)
    back = K.rowmajor_to_chunked(got, chunk=chunk)
    np.testing.assert_array_equal(to_numpy(back, dtype),
                                  np.asarray(back_ref))
    np.testing.assert_array_equal(to_numpy(back, dtype), x)


@pytest.mark.parametrize("seed", range(4))
def test_merge_blocks_device_matches_pallas_and_numpy(seed):
    rng = np.random.default_rng(seed)
    for jp, tp in _owned_plans((32, 32, 32), (8, 8, 8), 4, seed):
        data = {op.block_id: rng.standard_normal(op.src_block.shape)
                .astype(np.float32) for op in jp.copies}
        host = execute_merge_numpy(jp, data)
        pallas = jax_merge(jp, data, interpret=True)
        got = K.merge_blocks_device(
            tp, {k: torch.from_numpy(v) for k, v in data.items()})
        assert len(got) == len(host) == len(pallas)
        for g, h, p in zip(got, host, pallas):
            np.testing.assert_array_equal(g.numpy(), h)
            np.testing.assert_array_equal(g.numpy(), np.asarray(p))


def test_cpu_tensors_never_launch():
    K.reset_launch_counts()
    x = torch.arange(2 * 3 * 4 * 8, dtype=torch.float32).view(2, 3, 4, 8)
    rm = K.chunked_to_rowmajor(x, chunk=(4, 8))
    K.rowmajor_to_chunked(rm, chunk=(4, 8))
    K.pack_rows(rm, torch.arange(8, dtype=torch.int32),
                torch.arange(8, dtype=torch.int32), n_dst_rows=8, width=24)
    q = torch.zeros(1, 2, 4, 8, requires_grad=True)
    K.flash_attention(q, q, q).sum().backward()
    assert K.launch_counts() == {"pack_rows": 0, "chunked_to_rowmajor": 0,
                                 "rowmajor_to_chunked": 0,
                                 "flash_attention": 0,
                                 "flash_attention_d256": 0,
                                 "flash_attention_f32tc": 0,
                                 "flash_attention_simt": 0,
                                 "flash_attention_dq": 0,
                                 "flash_attention_dq_d256": 0,
                                 "flash_attention_dq_f32tc": 0,
                                 "flash_attention_dq_simt": 0,
                                 "flash_attention_dkv": 0,
                                 "flash_attention_dkv_d256": 0,
                                 "flash_attention_dkv_f32tc": 0,
                                 "flash_attention_dkv_simt": 0}


def test_wrappers_check_their_inputs():
    src = torch.zeros(64)
    rows = torch.arange(4, dtype=torch.int32)
    with pytest.raises(IndexError):
        K.pack_rows(src, rows + 13, rows, n_dst_rows=4, width=4)
    with pytest.raises(IndexError):
        K.pack_rows(src, rows, rows, n_dst_rows=3, width=4)
    with pytest.raises(TypeError):
        K.pack_rows(src, rows.long(), rows, n_dst_rows=4, width=4)
    with pytest.raises(ValueError):
        K.pack_rows(src, rows, rows[:3], n_dst_rows=4, width=4)
    with pytest.raises(ValueError):
        K.pack_rows(src, rows, rows, n_dst_rows=4, width=5)
    with pytest.raises(ValueError):
        K.pack_rows(src.view(8, 8).t(), rows, rows, n_dst_rows=4, width=4)
    with pytest.raises(ValueError):
        K.rowmajor_to_chunked(torch.zeros(8, 12), chunk=(4, 8))
    with pytest.raises(ValueError):
        K.chunked_to_rowmajor(torch.zeros(2, 2, 4, 8), chunk=(8, 4))
    with pytest.raises(ValueError):
        K.chunked_to_rowmajor(torch.zeros(2, 2, 4, 8, device="meta"),
                              chunk=(4, 8))


def _tables():
    """Row tables of 4-element rows over a 64-element source and
    destination, the destination in reverse."""
    return np.arange(16, dtype=np.int32), np.arange(15, -1, -1,
                                                    dtype=np.int32)


@pytest.mark.parametrize("bad", ["int64", "two_dims", "src_low", "src_high",
                                 "dst_high", "lengths"])
def test_pack_tables_checks_host_tables_as_the_device_check(bad):
    """``ops.pack_tables`` checks the numpy tables on the host (the main
    path's route, which leaves no device-to-host sync) and raises what
    ``pack_rows``'s check of the same tables as tensors raises: TypeError
    for a dtype or shape, IndexError for a row outside the buffer it
    indexes, ValueError for tables of two lengths."""
    from repro_torch.kernels.ops import pack_tables
    sr, dr = _tables()
    if bad == "int64":
        sr = sr.astype(np.int64)
    elif bad == "two_dims":
        sr, dr = sr.reshape(4, 4), dr.reshape(4, 4)
    elif bad == "src_low":
        sr = sr - 1
    elif bad == "src_high":
        sr = sr + 1
    elif bad == "dst_high":
        dr = dr + 1
    else:
        dr = dr[:-1]
    src = torch.arange(64, dtype=torch.float32)
    with pytest.raises((TypeError, IndexError, ValueError)) as host:
        pack_tables(src, (4, sr, dr, 64, {}))
    with pytest.raises((TypeError, IndexError, ValueError)) as device:
        K.pack_rows(src, torch.from_numpy(sr), torch.from_numpy(dr),
                    n_dst_rows=16, width=4)
    assert host.type is device.type


def test_pack_tables_takes_covering_tables_unfilled():
    """On tables that name every destination row once (the main path's,
    ``_covered=True``) ``pack_tables`` equals the Pallas ``pack_rows``."""
    from repro_torch.kernels.ops import pack_tables
    sr, dr = _tables()
    src = np.random.default_rng(3).standard_normal(64).astype(np.float32)
    got = pack_tables(torch.from_numpy(src), (4, sr, dr, 64, {}),
                      _covered=True)
    ref = jax_pack_rows(jnp.asarray(src), jnp.asarray(sr), jnp.asarray(dr),
                        n_dst_rows=16, width=4, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).reshape(-1))


def test_merge_blocks_device_zeros_rows_no_block_names():
    """A plan whose cluster holds rows that no block names
    (``merge_blocks_device`` does not claim coverage, so the output is
    zero-filled): zeros there, bit-equal to the Pallas ``pack_rows`` on the
    same row tables."""
    cluster = tc.Cluster(tc.Block((0, 0), (8, 12)),
                         (tc.Block((0, 0), (4, 8), block_id=0),
                          tc.Block((4, 4), (8, 12), block_id=1)))
    plan = tc.plan_from_clusters([cluster])
    rng = np.random.default_rng(4)
    data = {b: rng.standard_normal((4, 8)).astype(np.float32)
            for b in (0, 1)}
    (got,) = K.merge_blocks_device(
        plan, {b: torch.from_numpy(x) for b, x in data.items()})
    width, sr, dr, total, _ = plan_row_tables(plan)
    flat = np.concatenate([data[0].reshape(-1), data[1].reshape(-1)])
    ref = jax_pack_rows(jnp.asarray(flat), jnp.asarray(sr), jnp.asarray(dr),
                        n_dst_rows=total // width, width=width,
                        interpret=True)
    np.testing.assert_array_equal(got.numpy().reshape(-1),
                                  np.asarray(ref).reshape(-1))
    assert not got[:4, 8:].any() and not got[4:, :4].any()
    np.testing.assert_array_equal(got[:4, :8].numpy(), data[0])


def test_device_glue_claims_coverage_only_after_lower(monkeypatch, tmp_path):
    """``io.device`` hands ``pack_tables`` its tables with ``_covered=True``
    (the output unfilled) on both of its routes, each after ``_lower``
    has shown that they cover every destination row."""
    import repro_torch.io.device as device
    from repro_torch.io import Dataset
    calls = []
    real = device.pack_tables

    def spy(flat, tables, **kw):
        calls.append(kw)
        return real(flat, tables, **kw)

    monkeypatch.setattr(device, "pack_tables", spy)
    shape = (32, 48)
    blocks = tc.simulate_load_balance(
        tc.uniform_grid_blocks(shape, (8, 16)), num_procs=3, seed=1)
    field = torch.arange(32 * 48, dtype=torch.float32).view(shape)
    data = {b.block_id: field[b.slices()].contiguous() for b in blocks}
    layout = tc.plan_layout("merged_process", blocks, num_procs=3)
    ds = Dataset.create(str(tmp_path), device="cpu")
    ds.write("E", layout, np.float32, data)
    ds.close()
    ds = Dataset.open(str(tmp_path), device="cpu")
    got, _ = ds.read("E", tc.Block((0, 0), shape))
    ds.close()
    assert torch.equal(got, field)
    assert calls and all(kw == {"_covered": True} for kw in calls)


def test_build_keeps_each_librarys_ptxas_log(tmp_path, monkeypatch):
    """A library built earlier is reused, and ``build_all`` still returns
    the compiler's report kept beside it."""
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc-is-not-run")
    out = tmp_path / _build._digest()
    out.mkdir()
    for name in _build.SOURCES:
        (out / f"lib{name}.so").write_bytes(b"")
        (out / f"lib{name}.log").write_text(f"ptxas info : {name}\n")
    info = _build.build_all()
    assert set(info) == set(_build.SOURCES)
    for name, v in info.items():
        assert v["seconds"] == 0.0
        assert v["log"] == f"ptxas info : {name}\n"


def test_chip_smoke_reads_spills_from_the_ptxas_report():
    """Phase 1's summary of ``ptxas -v``: entry count, most registers, and
    only the entries that spill, with their store and load bytes."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    log = "\n".join([
        "ptxas info    : 0 bytes gmem",
        "ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1av",
        "    24 bytes stack frame, 24 bytes spill stores, 28 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 24 bytes "
        "cumulative stack size",
        "ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1bv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 254 registers, used 1 barriers"])
    rep = chip_smoke.ptxas_report(log)
    assert rep["entries"] == 2 and rep["max_registers"] == 254
    assert list(rep["spills"].values()) == [[24, 28]]
    assert list(rep["spills"])[0] in ("_Z1av", "a()")
    assert chip_smoke.ptxas_report("") == {"entries": 0, "max_registers": 0,
                                           "spills": {}}
