"""The port's ``make_train_step_reduce_once`` (``train/trainer.py``)
against the JAX package's, on the CPU: deepseek-moe-16b's and
qwen2.5-3b's smoke configs on meshes (1, 2), (2, 1) and (2, 2), two steps
of 2 microbatches a data rank, in f32.

The JAX package runs on 4 host devices in subprocesses (``XLA_FLAGS``);
the port runs in gloo worlds of 2 and 4 spawned ranks, params and AdamW
state as DTensors over the mesh.  Both take the same params (fan-in
scaled normals from a numpy seed) and batches.  Each step's loss and
gradient norm are held at rtol 1e-5, both AdamW moments after the first
step (the step's reduced gradients, scaled) within 1e-4 of each leaf's
max.  The params after the second step are held to 5% of the summed
learning rates: AdamW's first steps move a weight by about lr whatever
its gradient's size, so a gradient near 0 moves it by its sign (and the
second step's gradients are taken at those params).

On the (1, 2) mesh the JAX package's own reduce-once step fails to
compile with jax 0.9 (XLA: "Cross-partition allreduce must be in
(partial) manual partitioning mode"): with one data rank it is its
``make_train_step`` with the same microbatches, which the port's (1, 2)
step is held to instead.  The JAX package's step does not depend on its
model axis (the partitioner keeps the arithmetic; its (2, 1) and (2, 2)
losses agree to every digit), so it runs once, on (2, 2), for the port's
(2, 1) and (2, 2) steps."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
#: the JAX package's runs, and the one each port mesh is held to
REFERENCE = {"1x2": (1, 2), "2x2": (2, 2)}
HELD_TO = {"1x2": "1x2", "2x1": "2x2", "2x2": "2x2"}
ARCHS = ["deepseek-moe-16b", "qwen2.5-3b"]
ACCUM, ROWS, SEQ, STEPS = 2, 4, 16, 2
OPT = dict(peak_lr=1e-2, warmup_steps=1, total_steps=10)
RTOL, GRAD_GAP, LR_SHARE = 1e-5, 1e-4, 0.05


def _params(arch: str) -> dict:
    """Every leaf of ``arch``'s smoke skeleton by path name: zeros and ones
    as its init says, else normals at fan-in over the dims its product
    contracts (attention at 1/sqrt(d_model) and 1/sqrt(heads x head_dim),
    where the reference's init makes every attention row an argmax)."""
    from repro_torch.checkpoint.blocks_map import flatten_pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM
    rng = np.random.default_rng(1)
    out = {}
    for name, d in flatten_pytree(LM(get_smoke_config(arch),
                                     device="cpu").skeleton()).items():
        if d.init in ("zeros", "ones"):
            out[name] = np.full(d.shape, d.init == "ones", np.float32)
            continue
        leaf = name.rsplit("/", 1)[-1]
        fan = (d.shape[-3] if leaf in ("wq", "wk", "wv") else
               d.shape[-3] * d.shape[-2] if leaf == "wo" else
               d.shape[-1] if leaf in ("embed", "lm_head") else
               d.shape[-2] if len(d.shape) >= 2 else 1)
        out[name] = (rng.standard_normal(d.shape) / np.sqrt(fan)
                     ).astype(np.float32)
    return out


def _batches(vocab: int) -> list:
    rng = np.random.default_rng(2)
    return [{k: rng.integers(0, vocab, (ROWS, SEQ)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(STEPS)]


def _nest(flat: dict, leaf=lambda a: a):
    """A tree from path names (digit keys become list items)."""
    tree = {}
    for name, a in flat.items():
        node = tree
        *head, last = name.split("/")
        for part in head:
            node = node.setdefault(part, {})
        node[last] = leaf(a)

    def lists(t):
        if not isinstance(t, dict):
            return t
        t = {k: lists(v) for k, v in t.items()}
        if t and all(k.isdigit() for k in t):
            return [t[str(i)] for i in range(len(t))]
        return t
    return lists(tree)


_JAX = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
sys.path.insert(0, sys.argv[3])
import test_torch_reduce_once as T
import repro.models.layers as jlayers
from repro.configs import get_smoke_config
from repro.launch.mesh import make_mesh_compat
from repro.models import LM
from repro.train.optimizer import OptimizerConfig, adamw_init
from repro.train.trainer import make_train_step, make_train_step_reduce_once
jlayers._COMPUTE = jnp.float32
arch = sys.argv[2]
out = {}
model = LM(get_smoke_config(arch))
flat = T._params(arch)
ocfg = OptimizerConfig(**T.OPT)
batches = [{k: jnp.asarray(v) for k, v in b.items()}
           for b in T._batches(model.cfg.vocab)]
for tag, shape in T.REFERENCE.items():
    mesh = make_mesh_compat(shape, ("data", "model"))
    if shape[0] == 1:       # its reduce-once fails to compile (docstring)
        step = jax.jit(make_train_step(model, ocfg, T.ACCUM))
    else:
        step = jax.jit(make_train_step_reduce_once(model, ocfg, T.ACCUM,
                                                   mesh))
    params = T._nest(flat, jnp.asarray)
    opt = adamw_init(params)
    for i, b in enumerate(batches):
        params, opt, m = step(params, opt, b)
        for k in ("loss", "grad_norm"):
            out[f"{tag}/{i}/{k}"] = np.asarray(m[k])
        for what, tree in (("params", params), ("m", opt["m"]),
                           ("v", opt["v"])):
            leaves = jax.tree_util.tree_leaves(tree)
            for n, a in zip(sorted(flat), leaves):
                out[f"{tag}/{i}/{what}/{n}"] = np.asarray(a)
np.savez(sys.argv[1], **out)
"""


def _world(rank, world, init, out_path):
    """A rank of the port's world: both archs on this world's meshes;
    rank 0 saves the results."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    import repro_torch.models.layers as tlayers
    from repro_torch.checkpoint.blocks_map import flatten_pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.train import (OptimizerConfig, adamw_init,
                                   make_train_step_reduce_once)
    tlayers._COMPUTE = torch.float32
    torch.set_num_threads(1)       # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    out = {}
    for arch in ARCHS:
        model = LM(get_smoke_config(arch), device="cpu")
        defs = flatten_pytree(model.skeleton())
        flat = _params(arch)
        for tag, shape in MESHES.items():
            if np.prod(shape) != world:
                continue
            mesh = make_mesh(shape, ("data", "model"), "cpu")
            with shd.use_sharding(mesh) as ctx:
                params = _nest({n: distribute_tensor(
                    torch.tensor(a), mesh,
                    ctx.placements(defs[n].axes, a.shape),
                    src_data_rank=None) for n, a in flat.items()})
                opt = adamw_init(params)
                step = make_train_step_reduce_once(
                    model, OptimizerConfig(**OPT), ACCUM, mesh)
                for i, b in enumerate(_batches(model.cfg.vocab)):
                    params, opt, m = step(params, opt, {
                        k: torch.from_numpy(v) for k, v in b.items()})
                    for k in ("loss", "grad_norm"):
                        out[f"{arch}/{tag}/{i}/{k}"] = m[k].numpy().copy()
                    for what, tree in (("params", params), ("m", opt["m"]),
                                       ("v", opt["v"])):
                        for n, t in flatten_pytree(tree).items():
                            out[f"{arch}/{tag}/{i}/{what}/{n}"] = \
                                t.full_tensor().numpy().copy()
    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("reduce_once")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1",    # beside the worlds
               PYTHONPATH=str(ROOT / "src"))
    # one reference process an arch, both while the port's worlds run
    refs = {arch: subprocess.Popen(
        [sys.executable, "-c", _JAX, str(d / f"{arch}.npz"), arch,
         str(pathlib.Path(__file__).parent)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for arch in ARCHS}
    try:
        worlds = [torch.multiprocessing.spawn(_world, args=(
            world, f"file://{d / f'store{world}'}",
            str(d / f"torch{world}.npz")), nprocs=world, join=False)
            for world in (2, 4)]            # both worlds at once
        for w in worlds:
            while not w.join():
                pass
        got = {}
        for world in (2, 4):
            got.update(np.load(d / f"torch{world}.npz"))
        for arch, p in refs.items():
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in refs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    want = {f"{arch}/{k}": v for arch in ARCHS
            for k, v in np.load(d / f"{arch}.npz").items()}
    return want, got


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_reduce_once_steps_match_the_reference(results, arch, mesh):
    want, got = results
    key, ref = f"{arch}/{mesh}", f"{arch}/{HELD_TO[mesh]}"

    def pair(suffix):
        return got[f"{key}/{suffix}"], want[f"{ref}/{suffix}"]
    for i in range(STEPS):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(*pair(f"{i}/{k}"), rtol=RTOL)
    last = f"{STEPS - 1}/params/"
    leaves = [k[len(ref) + 1:] for k in want if k.startswith(f"{ref}/{last}")]
    assert leaves and len(leaves) == len(
        [k for k in got if k.startswith(f"{key}/{last}")])
    for what in ("m", "v"):
        for k in leaves:
            a, b = pair(k.replace(last, f"0/{what}/"))
            scale = max(float(np.abs(b).max()), 1e-30)
            gap = float(np.abs(a - b).max()) / scale
            assert gap < GRAD_GAP, (k, what, gap)
    from repro_torch.train import OptimizerConfig, warmup_cosine
    lrs = sum(float(warmup_cosine(OptimizerConfig(**OPT), i + 1))
              for i in range(STEPS))
    for k in leaves:
        a, b = pair(k)
        gap = float(np.abs(a - b).max())
        assert gap < LR_SHARE * lrs, (k, gap, lrs)
