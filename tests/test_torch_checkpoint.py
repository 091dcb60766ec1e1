"""The port's checkpoint package against the JAX package's, on the CPU:
tree names, the ``index.json`` chunk tables and ``manifest.json`` of every
fixed strategy, restores across the packages both ways, elastic restores
and the resharding report, retention and scalars, what waits for a later
slice, ``discover_prior``, and ``MeshSharding`` against JAX's
``NamedSharding`` on forced 8-device CPU meshes.  The same numpy tree goes
to both packages; every comparison is exact."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import blocks_from_sharding as jblocks_from_sharding
from repro.checkpoint import flatten_pytree as jflatten
from repro.checkpoint import plan_reshard as jplan_reshard
from repro.checkpoint import reshard_cost_report as jreshard_cost_report
import repro.core.blocks as jblocks
from repro.io import Dataset as JDataset

import repro_torch.core.blocks as tblocks
import repro_torch.kernels as K
from repro_torch.checkpoint import (ACCESS_PRIOR_NAME, CheckpointManager,
                                    MeshSharding, RestoreStats,
                                    blocks_from_sharding, flatten_pytree,
                                    plan_reshard, reshard_cost_report,
                                    unflatten_like)
from repro_torch.io import Dataset, ReadStats

ROOT = pathlib.Path(__file__).resolve().parents[1]
STRATEGIES = ["chunked", "subfiled_fpp", "merged_process", "reorganized"]
MLP = "segments/0/mlp/w_up"


def _fake_tree(seed=0):
    """``tests/test_checkpoint.py``'s tree, plus a float64 3-D leaf."""
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((64, 32)).astype(np.float32),
        "segments": [{"attn": {"wq": rng.standard_normal(
            (4, 32, 16)).astype(np.float32)},
            "mlp": {"w_up": rng.standard_normal((6, 20, 12))}}],
        "count": np.asarray(7, np.int32),
    }


def _block_map(blocks):
    """``tests/test_checkpoint.py``'s map (embed 4x2 over 8 simulated
    hosts; wq on dim 1 over 4) and the 3-D leaf split on its middle axis
    over 5, for ``blocks`` = either package's ``core.blocks``."""
    return {
        "embed": blocks.shard_grid_blocks((64, 32), (4, 2),
                                          lambda idx: idx[0] * 2 + idx[1]),
        "segments/0/attn/wq": blocks.shard_grid_blocks(
            (4, 32, 16), (1, 4, 1), lambda idx: idx[1]),
        MLP: blocks.shard_grid_blocks((6, 20, 12), (1, 5, 1),
                                      lambda idx: idx[1] // 2),
    }


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    return torch.from_numpy(np.array(tree))


def _scheme(strategy):
    return (2, 2) if strategy == "reorganized" else None


def _save_both(tmp_path, strategy, step=100):
    tree = _fake_tree()
    jm = JManager(str(tmp_path / "jax"), strategy=strategy,
                  reorg_scheme=_scheme(strategy))
    jm.save(step, tree, block_map=_block_map(jblocks))
    tm = CheckpointManager(str(tmp_path / "port"), strategy=strategy,
                           reorg_scheme=_scheme(strategy), device="cpu")
    stats = tm.save(step, _torch_tree(tree), block_map=_block_map(tblocks))
    return tree, jm, tm, stats


def _records(step_dir):
    with open(os.path.join(step_dir, "index.json")) as f:
        idx = json.load(f)
    return [(c["var"], c["lo"], c["hi"], c["subfile"], c["offset"],
             c["nbytes"], c.get("crc")) for c in idx["chunks"]]


def _manifest(step_dir):
    with open(os.path.join(step_dir, "manifest.json")) as f:
        return json.load(f)


def _assert_tree_equal(got, want):
    g, w = flatten_pytree(got), jflatten(want)
    assert list(g) == list(w)
    for name, t in g.items():
        a = np.asarray(w[name])
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert tuple(t.shape) == a.shape, name
        assert t.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(t.numpy(), a)


# -- (a) names -------------------------------------------------------------------

def test_flatten_names_and_order_follow_jax():
    rng = np.random.default_rng(1)
    leaf = lambda: rng.standard_normal(2)          # noqa: E731
    tree = {"z": [leaf(), None, (leaf(), leaf())],
            "a": {"y": leaf(), "b": leaf(), "m": None},
            "k": ({"q": leaf(), "c": [leaf()]}, leaf()), "n": None}
    ours, ref = flatten_pytree(tree), jflatten(tree)
    assert list(ours) == list(ref) == [
        "a/b", "a/y", "k/0/c/0", "k/0/q", "k/1", "z/0", "z/2/0", "z/2/1"]
    assert all(ours[k] is ref[k] for k in ref)
    assert list(flatten_pytree(tree, "opt/")) == list(jflatten(tree, "opt/"))
    back = unflatten_like(tree, {k: v * 2 for k, v in ours.items()})
    assert back["z"][1] is None and back["n"] is None
    assert isinstance(back["z"][2], tuple) and isinstance(back["k"], tuple)
    for k, v in flatten_pytree(back).items():
        np.testing.assert_array_equal(v, ours[k] * 2)


# -- (b) the container -------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_index_and_manifest_equal_the_reference(tmp_path, strategy):
    _, jm, tm, stats = _save_both(tmp_path, strategy)
    jd, td = jm.step_dir(100), tm.step_dir(100)
    assert _records(td) == _records(jd)
    assert _manifest(td) == _manifest(jd)
    assert _manifest(td)["scalars"] == {"count": {"dtype": "int32",
                                                  "value": 7}}
    for name in sorted(os.listdir(jd)):
        if name.endswith(".bin"):
            assert (pathlib.Path(td) / name).read_bytes() == \
                (pathlib.Path(jd) / name).read_bytes(), name
    assert stats.num_original_blocks == 8 + 4 + 5
    assert stats.bytes == sum(np.asarray(v).nbytes for k, v in
                              jflatten(_fake_tree()).items() if k != "count")


def test_save_takes_the_device_routes_on_cpu_tensors(tmp_path):
    """merged_process merges every leaf through ``pack_rows``' plain
    version (stages recorded); nothing launches on the CPU."""
    K.reset_launch_counts()
    _, _, _, stats = _save_both(tmp_path, "merged_process")
    assert stats.kernel_seconds > 0 and stats.d2h_seconds > 0
    assert stats.lower_seconds > 0 and stats.write_seconds > 0
    assert stats.num_chunks < stats.num_original_blocks
    assert set(K.launch_counts().values()) == {0}


# -- (c) across the packages -------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_port_save_restores_under_jax(tmp_path, strategy):
    tree, _, tm, _ = _save_both(tmp_path, strategy)
    reader = JManager(tm.root)
    got, _ = reader.restore(100, template=tree)
    for name, a in jflatten(tree).items():
        b = np.asarray(jflatten(got)[name])
        assert b.dtype == np.asarray(a).dtype and b.shape == np.shape(a)
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_jax_save_restores_under_port(tmp_path, strategy):
    tree, jm, _, _ = _save_both(tmp_path, strategy)
    reader = CheckpointManager(jm.root, device="cpu")
    got, stats = reader.restore(100, template=_torch_tree(tree))
    _assert_tree_equal(got, tree)
    assert got["count"].shape == () and got["count"].dtype == torch.int32
    _, jstats = jm.restore(100)
    assert (stats.bytes_read, stats.chunks_touched) == \
        (jstats.bytes_read, jstats.chunks_touched)


# -- (d, e) elastic restores and the resharding report ----------------------------

def _targets(blocks):
    # embed onto 2 hosts by rows (tests/test_checkpoint.py); wq onto a 3-D
    # grid whose middle cut (10, 11, 11) falls inside the stored chunks; the
    # 3-D leaf onto its last axis
    return {"embed": blocks.regular_decomposition((64, 32), (2, 1)),
            "segments/0/attn/wq": blocks.regular_decomposition(
                (4, 32, 16), (2, 3, 2)),
            MLP: blocks.regular_decomposition((6, 20, 12), (1, 1, 4))}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_elastic_restore_matches_the_reference(tmp_path, strategy):
    tree, jm, tm, _ = _save_both(tmp_path, strategy)
    jflat, jstats = jm.restore(100, target_blocks=_targets(jblocks))
    K.reset_launch_counts()
    flat, stats = tm.restore(100, target_blocks=_targets(tblocks))
    assert set(K.launch_counts().values()) == {0}
    assert isinstance(stats, RestoreStats)
    assert sorted(stats.per_var) == sorted(jstats.per_var)
    for name, targets in _targets(tblocks).items():
        shards = flat[name]
        assert sorted(shards) == [b.block_id for b in targets]
        for b in targets:
            np.testing.assert_array_equal(shards[b.block_id].numpy(),
                                          jflatten(tree)[name][b.slices()])
            np.testing.assert_array_equal(shards[b.block_id].numpy(),
                                          jflat[name][b.block_id])
        vs, js = stats.per_var[name], jstats.per_var[name]
        assert isinstance(vs, ReadStats)
        assert (vs.bytes_read, vs.chunks_touched) == \
            (js.bytes_read, js.chunks_touched), name
        assert vs.linearize_seconds > 0 and vs.engine == "memmap"
    assert stats.bytes_read == jstats.bytes_read
    assert stats.chunks_touched == jstats.chunks_touched
    assert int(flat["count"]) == 7 and flat["count"].shape == ()


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_reshard_report_matches_the_reference(tmp_path, strategy):
    _, jm, tm, _ = _save_both(tmp_path, strategy)
    for name, targets in _targets(tblocks).items():
        jt = _targets(jblocks)[name]
        for d in (jm.step_dir(100), tm.step_dir(100)):
            assert reshard_cost_report(d, name, targets) == \
                jreshard_cost_report(d, name, jt)
            ours = plan_reshard(Dataset.open(d, device="cpu"), name, targets)
            ref = jplan_reshard(JDataset.open(d), name, jt)
            assert (ours.chunks_touched, ours.runs, ours.bytes,
                    ours.amplification) == (ref.chunks_touched, ref.runs,
                                            ref.bytes, ref.amplification)
            assert [(b.lo, b.hi) for b in ours.targets] == \
                [(b.lo, b.hi) for b in ref.targets]


# -- (f) retention, latest, scalars ------------------------------------------------

def test_retention_and_restore_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), keep=2, device="cpu")
    t = {"x": torch.ones((4, 4)), "count": torch.tensor(3, dtype=torch.int32)}
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": t["x"] * s, "count": t["count"] + s})
    assert mgr.steps() == [3, 4]
    step, tree = mgr.restore_latest(template=t)
    assert step == 4 and torch.equal(tree["x"], t["x"] * 4)
    assert tree["count"].shape == () and tree["count"].dtype == torch.int32
    assert int(tree["count"]) == 7
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty"),
                          device="cpu").restore_latest()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64, torch.float32,
                                   torch.float64, torch.bool], ids=str)
def test_scalars_keep_shape_and_dtype(tmp_path, dtype):
    mgr = CheckpointManager(str(tmp_path), device="cpu")
    t = {"w": torch.ones((4, 4)), "s": torch.tensor(42, dtype=dtype)}
    mgr.save(1, t)
    r, _ = mgr.restore(1, template=t)
    assert r["s"].shape == () and r["s"].dtype == dtype
    assert torch.equal(r["s"], t["s"])
    jr, _ = JManager(str(tmp_path)).restore(1)
    assert jr["s"].dtype == t["s"].numpy().dtype and jr["s"] == t["s"].item()


# -- (g) what waits for a later slice ------------------------------------------------

def test_unported_options_name_their_item(tmp_path):
    root = str(tmp_path)
    with pytest.raises(NotImplementedError, match="S3"):
        CheckpointManager(root, trace=object(), device="cpu")
    mgr = CheckpointManager(root, device="cpu")
    with pytest.raises(NotImplementedError, match="S9"):
        mgr.save(2, {"w": torch.ones(4, dtype=torch.bfloat16)})
    with pytest.raises(TypeError, match="'w' is a ndarray"):
        mgr.save(3, {"w": np.ones(4)})


def test_manager_needs_a_gpu_unless_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CheckpointManager(str(tmp_path))


# -- (h) discover_prior ---------------------------------------------------------------

def _export(root, mtime=None):
    os.makedirs(root, exist_ok=True)
    p = os.path.join(root, ACCESS_PRIOR_NAME)
    with open(p, "w") as f:
        json.dump({"records": []}, f)
    if mtime is not None:
        os.utime(p, (mtime, mtime))
    return p


def test_discover_prior_finds_newest_sibling(tmp_path):
    runs = tmp_path / "runs"
    _export(str(runs / "run_001"), mtime=1_000_000)
    p2 = _export(str(runs / "run_002"))
    (runs / "not_a_run.txt").write_text("x")
    m3 = CheckpointManager(str(runs / "run_003"), device="cpu")
    assert m3.discover_prior() == p2
    assert JManager(str(runs / "run_003")).discover_prior() == p2


def test_discover_prior_excludes_own_root_and_handles_none(tmp_path):
    runs = tmp_path / "runs"
    _export(str(runs / "run_001"))
    m1 = CheckpointManager(str(runs / "run_001"), device="cpu")
    assert m1.discover_prior() is None      # own root is not a sibling
    lone = CheckpointManager(str(tmp_path / "elsewhere" / "run_x"),
                             device="cpu")
    assert lone.discover_prior() is None    # cold start: no siblings at all


# -- (i) MeshSharding against NamedSharding ----------------------------------------

MESHES = {"8": ((8,), ("x",)), "2x4": ((2, 4), ("data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
SPECS = {
    "8": [("x",), (None, "x"), (), (("x",), None)],
    "2x4": [("data", "model"), (None, "model"), (("data", "model"),),
            (("model", "data"),), (), ("model", None, "data")],
    "4x2": [("data", "model"), (None, ("data", "model")), ("model",),
            (), (("model", "data"), None)],
}
SHAPES = [(64, 32), (64, 32, 8)]
_JAX_BLOCKS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.checkpoint import blocks_from_sharding
cases = json.loads(sys.argv[1])
out = []
for shape, axes, spec, arr in cases:
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    mesh = Mesh(np.array(jax.devices())[:int(np.prod(shape))].reshape(shape),
                tuple(axes))
    try:
        bl = blocks_from_sharding(tuple(arr), NamedSharding(mesh, P(*spec)),
                                  devices_per_host=4)
        out.append([[list(b.lo), list(b.hi), b.owner, b.block_id]
                    for b in bl])
    except ValueError as e:
        out.append("ValueError: " + str(e).split("\n")[0])
print(json.dumps(out))
"""


def _cases():
    cases = []
    for key, (shape, axes) in MESHES.items():
        for spec in SPECS[key]:
            for arr in SHAPES:
                if len(spec) <= len(arr):
                    cases.append((list(shape), list(axes), list(spec),
                                  list(arr)))
        # every mesh axis on one dimension of 6: 8 ways do not divide it
        cases.append((list(shape), list(axes), [list(axes)], [6, 32]))
    return cases


@pytest.fixture(scope="module")
def jax_blocks():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", _JAX_BLOCKS,
                        json.dumps(_cases())], env=env, capture_output=True,
                       text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_mesh_sharding_gives_named_sharding_blocks(jax_blocks):
    cases = _cases()
    assert len(jax_blocks) == len(cases)
    raised = 0
    for (shape, axes, spec, arr), want in zip(cases, jax_blocks):
        ids = np.arange(int(np.prod(shape))).reshape(shape)
        spec = [tuple(e) if isinstance(e, list) else e for e in spec]
        sh = MeshSharding(ids, axes, spec)
        if isinstance(want, str):
            assert "evenly divide" in want
            with pytest.raises(ValueError, match="evenly divide"):
                blocks_from_sharding(tuple(arr), sh)
            with pytest.raises(ValueError, match="evenly divide"):
                jblocks_from_sharding(tuple(arr), sh)
            raised += 1
            continue
        got = [[list(b.lo), list(b.hi), b.owner, b.block_id]
               for b in blocks_from_sharding(tuple(arr), sh)]
        assert got == want, (shape, spec, arr)
        ref = [[list(b.lo), list(b.hi), b.owner, b.block_id]
               for b in jblocks_from_sharding(tuple(arr), sh)]
        assert ref == want
    assert raised == len(MESHES)
    # the expected counts on mesh (2, 4) at shape (64, 32)
    count = {tuple(map(lambda e: tuple(e) if isinstance(e, list) else e,
                       c[2])): len(w)
             for c, w in zip(cases, jax_blocks)
             if c[0] == [2, 4] and c[3] == [64, 32]}
    assert count[("data", "model")] == 8 and count[(None, "model")] == 4
    assert count[(("data", "model"),)] == 8 and count[()] == 1


def test_mesh_sharding_refuses_bad_specs():
    ids = np.arange(8).reshape(2, 4)
    with pytest.raises(ValueError, match="more than one dimension"):
        MeshSharding(ids, ("data", "model"), ("model", "model"))
    with pytest.raises(ValueError, match="not axes"):
        MeshSharding(ids, ("data", "model"), ("pipe",))
    with pytest.raises(ValueError, match="more entries"):
        MeshSharding(ids, ("data", "model"),
                     (None, None, "model")).devices_indices_map((8, 8))


def test_save_derives_blocks_from_shardings(tmp_path):
    """A tree of MeshShardings: 2 hosts x 4 devices, each leaf split 8 ways
    on its first axis 8 divides; merged_process leaves 2 chunks a leaf
    (one a host) against subfiled_fpp's 8, and the restore is exact."""
    rng = np.random.default_rng(2)
    tree = {"embed": torch.from_numpy(rng.standard_normal((48, 16))),
            "w": torch.from_numpy(rng.standard_normal((3, 16, 4))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal(5)
                                  .astype(np.float32))}
    ids = np.arange(8).reshape(2, 4)

    def spec(shape):
        for d, n in enumerate(shape):
            if n % 8 == 0:
                return (None,) * d + (("host", "dev"),)
        return ()
    sh = {k: MeshSharding(ids, ("host", "dev"), spec(v.shape))
          for k, v in tree.items()}
    merged = CheckpointManager(str(tmp_path / "m"), device="cpu")
    st = merged.save(1, tree, shardings=sh)
    assert st.num_original_blocks == 8 + 8 + 1 and st.num_chunks == 2 + 2 + 1
    fpp = CheckpointManager(str(tmp_path / "f"), strategy="subfiled_fpp",
                            device="cpu")
    assert fpp.save(1, tree, shardings=sh).num_chunks == 8 + 8 + 1
    got, _ = merged.restore(1, template=tree)
    for k in tree:
        assert torch.equal(got[k], tree[k])
