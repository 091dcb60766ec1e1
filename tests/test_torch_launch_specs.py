"""The port's ``launch/specs.py`` against the JAX package's: the model
flops estimate of every registered arch and shape, the fake args of
``build_cell`` (shape, dtype and spec of every leaf) on meshes (1, 1),
(1, 2), (2, 2) and (16, 16), the documented skips' words, and ZeRO-1
moments placed by ``zero_moment_defs``.

The port's cells are built in a subprocess, rank 0 of a fake world
(``torch.testing._internal.distributed.fake_pg``) of each mesh's size;
each DTensor leaf's spec is read back from its placements.  The
reference's cells are built in this process with its ``ShapeDtypeStruct``
stand-ins replaced by (shape, dtype, spec) records: its
``ShardingCtx.spec`` reads only the mesh's axis sizes, so no 256-device
mesh is needed.  A decode cell's position is an int in the port and a
traced scalar in the reference: it is left out of the comparison."""

import json
import os
import pathlib
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import list_archs as jlist_archs
from repro.configs import shapes_for as jshapes_for
from repro.configs import skip_reason as jskip_reason
from repro.distributed import sharding as jshd
from repro.launch import specs as jspecs
from repro.models.model import LM as JLM
from repro.configs import get_config as jget_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x1": (1, 1), "1x2": (1, 2), "2x2": (2, 2), "16x16": (16, 16)}
CELLS = [(a, s.name) for a in jlist_archs() for s in jshapes_for(a)]
LIVE = [(a, s) for a, s in CELLS if not jskip_reason(a, s)]

_PORT = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.checkpoint.blocks_map import dtensor_sharding
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.models.params import tree_leaves
meshes, cells = json.loads(sys.argv[2]), json.loads(sys.argv[3])
out = {}
for tag, shape in meshes.items():
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    for arch, cell, zero1 in cells:
        cfg = get_config(arch)
        rules = shd.FSDP_RULES if cfg.fsdp else shd.DEFAULT_RULES
        with shd.use_sharding(mesh, rules):
            c = build_cell(arch, cell, zero1=zero1, device="cpu")
        leaves = []
        for t in tree_leaves(list(c.args)):
            if not isinstance(t, torch.Tensor):
                continue
            spec = [list(e) if isinstance(e, tuple) else e
                    for e in dtensor_sharding(t).spec]
            while spec and spec[-1] is None:
                spec.pop()
            leaves.append([list(t.shape), str(t.dtype).split(".")[-1], spec])
        out[f"{tag}/{arch}/{cell}/{int(zero1)}"] = leaves
    dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""


def _cells():
    """Every live cell, and each train cell again with ZeRO-1 moments."""
    return [(a, s, False) for a, s in LIVE] + [
        (a, s, True) for a, s in LIVE
        if next(c for c in jshapes_for(a) if c.name == s).kind == "train"]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    out = tmp_path_factory.mktemp("specs") / "port.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _PORT, str(out),
                        json.dumps(MESHES), json.dumps(_cells())], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(out.read_text())


class _Leaf:
    """A reference stand-in as (shape, dtype, spec)."""

    def __init__(self, shape, dtype, spec):
        self.row = [list(shape), str(np.dtype(dtype)),
                    [list(e) if isinstance(e, tuple) else e for e in spec]]


def _reference(arch, cell, zero1, mesh_shape, monkeypatch):
    mesh = SimpleNamespace(shape=dict(zip(("data", "model"), mesh_shape)))
    cfg = jget_config(arch)
    rules = jshd.FSDP_RULES if cfg.fsdp else jshd.DEFAULT_RULES
    with jshd.use_sharding(mesh, rules) as ctx:
        monkeypatch.setattr(jspecs, "_sds", lambda shape, dtype, axes: _Leaf(
            shape, dtype, ctx.spec(axes, shape)))
        monkeypatch.setattr(jspecs, "abstract", lambda skel: jax.tree_util.
                            tree_map(lambda d: _Leaf(
                                d.shape, d.dtype, ctx.spec(d.axes, d.shape)),
                                skel, is_leaf=lambda x: hasattr(x, "init")))
        c = jspecs.build_cell(arch, cell, zero1=zero1)
    rows = []
    for t in jax.tree_util.tree_leaves(list(c.args),
                                       is_leaf=lambda x: isinstance(x,
                                                                    _Leaf)):
        if isinstance(t, _Leaf):
            rows.append(t.row)
        elif tuple(t.shape) == () and c.shape.kind == "train":
            rows.append([[], str(np.dtype(t.dtype)), []])   # the count
    return rows


@pytest.mark.parametrize("arch", jlist_archs())
def test_model_flops_estimate_matches_the_reference(arch):
    """``model_flops_estimate`` (6ND train, 2ND prefill, 2N a decoded
    token; MoE counts the active experts) equals the reference's for every
    shape of every registered arch."""
    from repro_torch.configs import get_config, shapes_for
    from repro_torch.launch.specs import model_flops_estimate
    from repro_torch.models import LM
    tm = LM(get_config(arch), device="cpu")
    jm = JLM(jget_config(arch))
    for tc, jc in zip(shapes_for(arch), jshapes_for(arch)):
        assert tc == jc or (tc.name, tc.kind, tc.seq_len, tc.global_batch) \
            == (jc.name, jc.kind, jc.seq_len, jc.global_batch)
        assert model_flops_estimate(tm, tc) == \
            jspecs.model_flops_estimate(jm, jc)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_build_cell_args_match_the_reference(port, mesh, monkeypatch):
    """On each mesh, every live cell's fake args (params, moments and
    count, batch or cache and tokens) have the reference's shapes, dtypes
    and specs, leaf for leaf; so do train cells with ZeRO-1 moments."""
    for arch, cell, zero1 in _cells():
        want = _reference(arch, cell, zero1, MESHES[mesh], monkeypatch)
        got = port[f"{mesh}/{arch}/{cell}/{int(zero1)}"]
        assert got == want, (mesh, arch, cell, zero1)


@pytest.mark.parametrize("arch,cell", [c for c in CELLS
                                       if jskip_reason(*c)])
def test_documented_skips_raise_the_same_words(arch, cell):
    """A documented skip raises ``ValueError`` with the reference's
    words."""
    from repro_torch.launch.specs import build_cell
    with pytest.raises(ValueError) as jerr:
        jspecs.build_cell(arch, cell)
    with pytest.raises(ValueError) as terr:
        build_cell(arch, cell, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_zero1_moments_take_zero_moment_defs_placements(port):
    """ZeRO-1 moments split over "data" where the param is whole: on mesh
    (2, 2) every moment leaf of qwen2.5-3b's train cell carries "data" in
    its spec, as ``zero_moment_defs`` places it, and its param does not."""
    rows = port["2x2/qwen2.5-3b/train_4k/1"]
    plain = port["2x2/qwen2.5-3b/train_4k/0"]
    n = (len(rows) - 3) // 3          # params, count, m, v, tokens, labels
    flat = lambda spec: [a for e in spec for a in (e if isinstance(e, list)
                                                     else [e]) if a]
    for p, m in zip(plain[:n], rows[n + 1:2 * n + 1]):
        assert "data" not in flat(p[2])
        assert "data" in flat(m[2]), (p, m)
