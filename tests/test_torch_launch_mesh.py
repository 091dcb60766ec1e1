"""The port's sharded state on the CPU: a sharded init (``LM.init`` under
a sharding context) equals the unsharded one leaf for leaf; a checkpoint
of DTensor leaves (``CheckpointManager.save`` in a world, rank 0 writing)
is byte for byte the single-process save of the same full tree under the
matching ``MeshSharding``s, and restores onto each rank's blocks; and
``launch.train --mesh host`` trains under ``torch.distributed.run`` with
2 ranks.  The worlds are gloo worlds of 2 and 4 spawned ranks on meshes
(1, 2), (2, 1) and (2, 2)."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
ARCHS = ["qwen2.5-3b", "deepseek-moe-16b"]


def _same_tree(a: pathlib.Path, b: pathlib.Path) -> list:
    """Relative paths whose bytes differ between two directory trees (or
    exist in one only)."""
    fa = {p.relative_to(a) for p in a.rglob("*") if p.is_file()}
    fb = {p.relative_to(b) for p in b.rglob("*") if p.is_file()}
    bad = sorted(str(p) for p in fa ^ fb)
    for p in sorted(fa & fb):
        if (a / p).read_bytes() != (b / p).read_bytes():
            bad.append(str(p))
    return bad


def _world(rank, world, init, root):
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.blocks_map import (dtensor_sharding,
                                                   flatten_pytree)
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.models.params import shardings
    torch.set_num_threads(1)       # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    root = pathlib.Path(root)
    out = {}
    for arch in ARCHS:
        model = LM(get_smoke_config(arch), device="cpu")
        whole = model.init(torch.Generator().manual_seed(3))
        for tag, shape in MESHES.items():
            if np.prod(shape) != world:
                continue
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            key = f"{arch}/{tag}"
            with shd.use_sharding(mesh) as ctx:
                placed = model.init(torch.Generator().manual_seed(3))
                specs = shardings(model.skeleton())
            flat_p, flat_w = flatten_pytree(placed), flatten_pytree(whole)
            flat_s = flatten_pytree(specs)
            out[f"{key}/init_equal"] = all(
                torch.equal(flat_p[n].full_tensor(), flat_w[n])
                for n in flat_w)
            out[f"{key}/sharded_leaves"] = sum(
                any(pl.is_shard() for pl in t.placements)
                for t in flat_p.values())
            out[f"{key}/specs_match"] = all(
                tuple(dtensor_sharding(flat_p[n]).spec)
                == tuple(flat_s[n].spec) for n in flat_w)
            a, b = root / key / "dtensor", root / key / "single"
            CheckpointManager(str(a), device="cpu").save(5, placed)
            if rank == 0:
                CheckpointManager(str(b), device="cpu").save(
                    5, whole, shardings=specs)
            dist.barrier()
            out[f"{key}/bytes_differ"] = _same_tree(a, b) \
                if rank == 0 else []
            got, _ = CheckpointManager(str(a), device="cpu").restore(
                5, template=placed)
            out[f"{key}/restored_equal"] = all(
                torch.equal(t.to_local(), flat_p[n].to_local())
                and t.placements == flat_p[n].placements
                for n, t in flatten_pytree(got).items())
    gathered = [None] * world
    dist.all_gather_object(gathered, out)
    if rank == 0:
        merged = {k: [g[k] for g in gathered] for k in out}
        (root / f"world{world}.json").write_text(json.dumps(merged))
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("launch_mesh")
    worlds = [torch.multiprocessing.spawn(_world, args=(
        world, f"file://{d / f'store{world}'}", str(d)), nprocs=world,
        join=False) for world in (2, 4)]
    for w in worlds:
        while not w.join():
            pass
    out = {}
    for world in (2, 4):
        out.update(json.loads((d / f"world{world}.json").read_text()))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_equals_the_unsharded_one(results, arch, mesh):
    key = f"{arch}/{mesh}"
    assert all(results[f"{key}/init_equal"])
    assert all(results[f"{key}/specs_match"])
    if mesh != "2x1":               # the model axis splits some leaves
        assert min(results[f"{key}/sharded_leaves"]) > 0


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_dtensor_save_is_the_mesh_sharding_save(results, arch, mesh):
    """``index.json``, ``manifest.json`` and every subfile of the DTensor
    save equal the single-process save's; each rank restores its own
    blocks with the template's placements."""
    key = f"{arch}/{mesh}"
    assert results[f"{key}/bytes_differ"][0] == []
    assert all(results[f"{key}/restored_equal"])


def test_train_launcher_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--arch", "qwen2.5-3b", "--smoke", "--mesh", "host", "--device",
         "cpu", "--steps", "2", "--global-batch", "2", "--seq-len", "16",
         "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1"],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    assert out.count("arch=qwen2.5-3b-smoke device=cpu") == 1   # rank 0
    assert "mesh=host" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("loss "))
    assert np.isfinite([float(w) for w in line.split()[1::2]]).all()
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()
                  if p.name.startswith("step_")) == ["step_00000001",
                                                     "step_00000002"]
