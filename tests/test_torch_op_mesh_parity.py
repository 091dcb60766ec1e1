"""Per-device flop parity on meshes: each smoke config's train step
(batch 4 x 64, remat ``none``), counted per rank by the port's dry run
(``launch/dryrun.run_cell`` on fake worlds (1, 2) and (2, 2), rank 0)
against ``analyze_hlo`` of the JAX package's compiled step on 2 and 4
host devices (its per-device HLO after partitioning), with params,
moments and batch placed by the same rules.

They are equal but for two pinned gaps (``GAPS``), each with its cause:

* the SSD archs (mamba2-780m, hymba-1.5b): the port runs each SSD
  layer's input projection and chunk scan whole over "model" (per data
  shard, ``models/ssm._scan_per_shard``), the reference splits them over
  its heads: every model rank does the work the reference splits over
  them, and that excess halves from 1 to 2 data ranks (``ROADMAP.md``
  queue 2, the SSD heads);
* the MoE archs on (2, 2): the port splits the expert slots over the data
  ranks (``models/moe._moe_forward_sharded``'s reduce-scatter), the
  reference computes every slot on each data rank, so the port does half
  the reference's expert products on 2 data ranks (none on (1, 2)).

The archs are split over this file and
``tests/test_torch_op_mesh_parity_rest.py`` (each file under a minute)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.configs import list_archs

ROOT = pathlib.Path(__file__).resolve().parents[1]
B, L = 4, 64
MESHES = {"1x2": (1, 2), "2x2": (2, 2)}
#: this file's archs; the rest are ``test_torch_op_mesh_parity_rest.py``'s
ARCHS = list_archs()[:4]
#: port - reference flops a device, by (arch, mesh); absent: equal
GAPS = {("mamba2-780m", "1x2"): 69206016, ("mamba2-780m", "2x2"): 34603008,
        ("hymba-1.5b", "1x2"): 36175872, ("hymba-1.5b", "2x2"): 18087936,
        ("arctic-480b", "2x2"): -23592960,
        ("deepseek-moe-16b", "2x2"): -17694720}

_JAX = r"""
import json, sys
import jax, jax.numpy as jnp
from repro.configs import get_smoke_config
from repro.distributed import sharding as shd
from repro.launch.hlo_analysis import analyze_hlo
from repro.launch.mesh import make_mesh_compat
from repro.launch.specs import _batch_specs
from repro.models.model import LM
from repro.models.params import ParamDef, abstract
from repro.train.optimizer import OptimizerConfig
from repro.train.trainer import make_train_step
shape, archs, B, L = (json.loads(a) for a in sys.argv[2:6])
mesh = make_mesh_compat(tuple(shape), ("data", "model"))
out = {}
for arch in archs:
    cfg = get_smoke_config(arch)
    rules = shd.FSDP_RULES if cfg.fsdp else shd.DEFAULT_RULES
    with mesh, shd.use_sharding(mesh, dict(rules)):
        model = LM(cfg)
        skel = model.skeleton()
        mdefs = jax.tree_util.tree_map(
            lambda d: ParamDef(d.shape, d.axes, "float32", "zeros"), skel,
            is_leaf=lambda x: isinstance(x, ParamDef))
        opt = {"m": abstract(mdefs), "v": abstract(mdefs),
               "count": jax.ShapeDtypeStruct((), jnp.int32)}
        step = jax.jit(make_train_step(model, OptimizerConfig(), 1))
        hlo = step.lower(abstract(skel), opt, _batch_specs(
            cfg, B, L, with_labels=True)).compile().as_text()
        out[arch] = analyze_hlo(hlo).flops
json.dump(out, open(sys.argv[1], "w"))
"""

_TORCH = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_smoke_config
from repro_torch.configs.common import ShapeCell
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_mesh
shape, archs, B, L = (json.loads(a) for a in sys.argv[2:6])
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size=shape[0] * shape[1])
mesh = make_mesh(tuple(shape), ("data", "model"), "cpu")
out = {}
for arch in archs:
    rec = run_cell(arch, "train_4k", mesh, False, cfg=get_smoke_config(arch),
                   shape=ShapeCell("train_4k", "train", L, B))
    out[arch] = rec.get("hlo_flops_per_dev", rec.get("error"))
json.dump(out, open(sys.argv[1], "w"))
"""


def per_device_flops(archs, d) -> dict:
    """``{mesh: {arch: (port, reference)}}``: the four worlds (the port's
    fake ones, the reference's host devices) in subprocesses side by
    side, single-threaded."""
    base = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu")
    procs = {}
    for tag, shape in MESHES.items():
        n = shape[0] * shape[1]
        jenv = dict(base, XLA_FLAGS=f"--xla_force_host_platform_device_count"
                    f"={n} --xla_cpu_multi_thread_eigen=false "
                    "intra_op_parallelism_threads=1")
        for who, src, env in (("jax", _JAX, jenv), ("torch", _TORCH, base)):
            out = d / f"{who}_{tag}.json"
            procs[(who, tag)] = (out, subprocess.Popen(
                [sys.executable, "-c", src, str(out), json.dumps(shape),
                 json.dumps(archs), str(B), str(L)], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    got = {}
    for key, (out, p) in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        got[key] = json.loads(out.read_text())
    return {tag: {a: (got[("torch", tag)][a], got[("jax", tag)][a])
                  for a in archs} for tag in MESHES}


def check(flops, arch, mesh):
    port, ref = flops[mesh][arch]
    assert isinstance(port, float), port           # an error's message
    assert port - ref == GAPS.get((arch, mesh), 0), (port, ref)


@pytest.fixture(scope="module")
def flops(tmp_path_factory):
    return per_device_flops(ARCHS, tmp_path_factory.mktemp("mesh_flops"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_flops_equal_the_reference(flops, arch, mesh):
    check(flops, arch, mesh)
