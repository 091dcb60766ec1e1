"""The port's sharded model paths against the JAX package's on meshes
(1, 2), (2, 1) and (2, 2), on the CPU: MoE's ``local`` and ``gather``
dispatches on each rank's blocks (``models/moe.py``
``_moe_forward_sharded``), the SSD scan on each data shard
(``models/ssm.py`` ``_scan_per_shard``) and attention's per-shard flash
call (``models/attention.py`` ``_flash_sharded``).

The JAX package runs on 4 host devices in a subprocess (``XLA_FLAGS``),
its flash kernel in Pallas interpret mode; the port runs in gloo worlds of
2 and 4 spawned ranks, each tensor a DTensor placed by ``DEFAULT_RULES``.
Both take the same seeded inputs.  Outputs are held at rtol 1e-5 / atol
1e-6, every gradient within 1e-4 of its leaf's max |reference|.  The
local dispatch computes its capacity from each data shard's tokens and
averages aux over the data shards, as the reference does: on meshes with
a data axis its router gradient differs from the gather path's, and
must match the reference's local path.  The gather dispatch keeps the
whole batch's capacity and aux across the data shards."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
#: the MoE block of the comparison (the reference's own test dims)
MOE = dict(d_model=32, d_ff=16, n_experts=8, top_k=2, n_shared=1,
           dispatch="local")
X_SHAPE = (2, 12, 32)
#: result key: dispatch
DISPATCH = {"moe": "local", "moe_gather": "gather"}
#: the SSD block of the comparison: 4 heads, 2 chunks of 8
SSD = dict(d_model=32, d_inner=64, headdim=16, d_state=8)
SSD_X_SHAPE, SSD_CHUNK = (2, 16, 32), 8
#: flash cases: (Hq, Hkv); "kv_replicated": 1 kv head on a 2-way model
#: axis, so each rank slices its group of the replicated kv
FLASH = {"mha": (4, 4), "gqa": (4, 2), "kv_replicated": (4, 1)}
FLASH_B, FLASH_L, FLASH_D, FLASH_BLOCK = 2, 64, 16, 32
RTOL, ATOL, GRAD_GAP = 1e-5, 1e-6, 1e-4


def _moe_inputs() -> dict:
    """The MoE block's params (by path name, fan-in scaled normals) and
    input, from a numpy seed."""
    from repro_torch.models import moe as tmoe
    rng = np.random.default_rng(0)
    out = {}

    def walk(tree, prefix):
        for k in sorted(tree):
            d = tree[k]
            if isinstance(d, dict):
                walk(d, f"{prefix}{k}/")
                continue
            fan = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            out[f"{prefix}{k}"] = (rng.standard_normal(d.shape)
                                   / np.sqrt(fan)).astype(np.float32)
    walk(tmoe.moe_defs(tmoe.MoEDims(**MOE)), "")
    out["x"] = rng.standard_normal(X_SHAPE).astype(np.float32)
    return out


def _ssd_inputs() -> dict:
    """The SSD block's params (every leaf a seeded normal, fan-in scaled
    where it is a matrix) and input."""
    from repro_torch.models import ssm as tssm
    rng = np.random.default_rng(3)
    out = {}
    for k, d in sorted(tssm.ssd_defs(tssm.SSMDims(**SSD)).items()):
        scale = 1 / np.sqrt(d.shape[0]) if len(d.shape) == 2 else 0.5
        out[k] = (rng.standard_normal(d.shape) * scale).astype(np.float32)
    out["x"] = rng.standard_normal(SSD_X_SHAPE).astype(np.float32)
    return out


def _flash_inputs(case):
    Hq, Hkv = FLASH[case]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((FLASH_B, Hq, FLASH_L, FLASH_D)).astype(
        np.float32)
    k = rng.standard_normal((FLASH_B, Hkv, FLASH_L, FLASH_D)).astype(
        np.float32)
    v = rng.standard_normal((FLASH_B, Hkv, FLASH_L, FLASH_D)).astype(
        np.float32)
    cot = rng.standard_normal(q.shape).astype(np.float32)
    return q, k, v, cot


_JAX = r"""
import dataclasses
import sys
import numpy as np
import jax
import jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
import test_torch_distributed as T
from repro.distributed import sharding as shd
from repro.launch.mesh import make_mesh_compat
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models.attention import _flash_sharded
out = {}
dims = jmoe.MoEDims(**T.MOE)
inputs = T._moe_inputs()
x = inputs.pop("x")
names = sorted(inputs)
p = {}
for n in names:
    node = p
    *head, last = n.split("/")
    for part in head:
        node = node.setdefault(part, {})
    node[last] = jnp.asarray(inputs[n])
for tag, shape in T.MESHES.items():
    mesh = make_mesh_compat(shape, ("data", "model"))
    for key, dispatch in T.DISPATCH.items():
        dd = dataclasses.replace(dims, dispatch=dispatch)

        def f(pp, xx):
            with shd.use_sharding(mesh, shd.DEFAULT_RULES):
                y, aux = jmoe.moe_forward(pp, xx, dd)
            return jnp.sum(y * y) + aux, (y, aux)
        (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
        out[f"{key}/{tag}/y"] = np.asarray(y)
        out[f"{key}/{tag}/aux"] = np.asarray(aux)
        out[f"{key}/{tag}/grad/x"] = np.asarray(gx)
        for n, leaf in zip(names, jax.tree_util.tree_leaves(gp)):
            out[f"{key}/{tag}/grad/{n}"] = np.asarray(leaf)
    sp = {k: jnp.asarray(a) for k, a in T._ssd_inputs().items()}
    sx = sp.pop("x")

    def fs(pp, xx):
        with shd.use_sharding(mesh, shd.DEFAULT_RULES):
            y = jssm.ssd_forward(pp, xx, jssm.SSMDims(**T.SSD), T.SSD_CHUNK)
        return jnp.sum(y * y), y
    (_, y), (gp, gx) = jax.jit(jax.value_and_grad(
        fs, argnums=(0, 1), has_aux=True))(sp, sx)
    out[f"ssd/{tag}/y"], out[f"ssd/{tag}/grad/x"] = np.asarray(y), np.asarray(gx)
    for n in sp:
        out[f"ssd/{tag}/grad/{n}"] = np.asarray(gp[n])
    for case in T.FLASH:
        q, k, v, cot = (jnp.asarray(a) for a in T._flash_inputs(case))

        def g(a, b, c, ct):
            def fa(a, b, c):
                return _flash_sharded(a, b, c, T.FLASH_D ** -0.5, True, None,
                                      None, T.FLASH_BLOCK)
            with shd.use_sharding(mesh, shd.DEFAULT_RULES):
                o, vjp = jax.vjp(fa, a, b, c)
                return (o, *vjp(ct))
        got = jax.jit(g)(q, k, v, cot)
        for n, a in zip(("o", "dq", "dk", "dv"), got):
            out[f"flash/{tag}/{case}/{n}"] = np.asarray(a)
np.savez(sys.argv[1], **out)
"""


def _world(rank, world, init, out_path):
    """A rank of the port's world: every case on this world's meshes, as
    DTensors placed by DEFAULT_RULES; rank 0 saves the gathered results."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as tmoe
    from repro_torch.models import ssm as tssm
    from repro_torch.models.attention import _flash_sharded
    torch.set_num_threads(1)       # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    ref = _moe_inputs()
    dims = tmoe.MoEDims(**MOE)
    defs = tmoe.moe_defs(dims)
    names = sorted(k for k in ref if k != "x")
    out = {}
    ffn = tmoe._expert_ffn
    buffers = []

    def spy(w, h, dtype):           # the experts' buffer each rank runs
        buffers.append(tuple(h.shape))
        return ffn(w, h, dtype)
    tmoe._expert_ffn = spy
    scan = tssm._ssd_scan
    rows = []

    def scan_spy(p, x, dims, chunk):     # the rows each rank scans
        rows.append(x.shape[0])
        return scan(p, x, dims, chunk)
    tssm._ssd_scan = scan_spy
    for tag, shape in MESHES.items():
        if np.prod(shape) != world:
            continue
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        with shd.use_sharding(mesh, shd.DEFAULT_RULES) as ctx:
            def place(a, axes):
                return distribute_tensor(
                    torch.from_numpy(a), mesh,
                    ctx.placements(axes, a.shape),
                    src_data_rank=None).requires_grad_()
            for key, dispatch in DISPATCH.items():
                leaves = {}
                for n in names:
                    d = defs
                    for part in n.split("/"):
                        d = d[part]
                    leaves[n] = place(ref[n], d.axes)
                p = {}
                for n, t in leaves.items():
                    node = p
                    *head, last = n.split("/")
                    for part in head:
                        node = node.setdefault(part, {})
                    node[last] = t
                x = place(ref["x"], ("batch", None, "act_embed"))
                buffers.clear()
                with shd.replicate_plain():
                    y, aux = tmoe.moe_forward(
                        p, x, dataclasses.replace(dims, dispatch=dispatch))
                    (torch.sum(y * y) + aux).backward()
                out[f"{key}/{tag}/y"] = y.full_tensor().detach().numpy()
                out[f"{key}/{tag}/aux"] = aux.full_tensor().detach().numpy()
                out[f"{key}/{tag}/grad/x"] = x.grad.full_tensor().numpy()
                for n, t in leaves.items():
                    out[f"{key}/{tag}/grad/{n}"] = \
                        t.grad.full_tensor().numpy()
                out[f"{key}/{tag}/buffer"] = np.array(buffers)
            sref = _ssd_inputs()
            sdefs = tssm.ssd_defs(tssm.SSMDims(**SSD))
            sp = {k: place(sref[k], sdefs[k].axes) for k in sdefs}
            sx = place(sref["x"], ("batch", None, "act_embed"))
            rows.clear()
            with shd.replicate_plain():
                y = tssm.ssd_forward(sp, sx, tssm.SSMDims(**SSD), SSD_CHUNK)
                torch.sum(y * y).backward()
            out[f"ssd/{tag}/y"] = y.full_tensor().detach().numpy()
            out[f"ssd/{tag}/grad/x"] = sx.grad.full_tensor().numpy()
            for k, t in sp.items():
                out[f"ssd/{tag}/grad/{k}"] = t.grad.full_tensor().numpy()
            out[f"ssd/{tag}/rows"] = np.array(rows)
            # one decoded token from the prefill's cache, per data shard,
            # against the same decode on whole tensors
            with torch.no_grad(), shd.replicate_plain():
                _, cache = tssm.ssd_forward_with_state(
                    sp, sx, tssm.SSMDims(**SSD), SSD_CHUNK)
                x1 = sx[:, -1:] * 0.5
                y1, cache = tssm.ssd_decode(sp, x1, cache,
                                            tssm.SSMDims(**SSD))
            plain = {k: t.full_tensor().detach() for k, t in sp.items()}
            with torch.no_grad():
                _, pc = tssm.ssd_forward_with_state(
                    plain, sx.full_tensor().detach(), tssm.SSMDims(**SSD),
                    SSD_CHUNK)
                py1, pc = tssm.ssd_decode(plain, x1.full_tensor(), pc,
                                          tssm.SSMDims(**SSD))
            out[f"ssd_decode/{tag}/y"] = y1.full_tensor().numpy()
            out[f"ssd_decode/{tag}/S"] = cache["S"].full_tensor().numpy()
            out[f"ssd_decode/{tag}/plain_y"] = py1.numpy()
            out[f"ssd_decode/{tag}/plain_S"] = pc["S"].numpy()
            for case in FLASH:
                q, k, v, cot = _flash_inputs(case)
                axes = ("batch", "act_heads", None, None)
                tq, tk, tv = (place(a, axes) for a in (q, k, v))
                with shd.replicate_plain():
                    o = _flash_sharded(tq, tk, tv, FLASH_D ** -0.5, True,
                                       None, None, FLASH_BLOCK)
                    o.backward(distribute_tensor(torch.from_numpy(cot), mesh,
                                                 o.placements,
                                                 src_data_rank=None))
                for n, a in (("o", o.detach()), ("dq", tq.grad),
                             ("dk", tk.grad), ("dv", tv.grad)):
                    out[f"flash/{tag}/{case}/{n}"] = a.full_tensor().numpy()
    if rank == 0:
        np.savez(out_path, **out)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("distributed")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1",    # beside the worlds
               PYTHONPATH=str(ROOT / "src"))
    # the reference runs while the port's worlds do
    ref = subprocess.Popen([sys.executable, "-c", _JAX, str(d / "jax.npz"),
                            str(pathlib.Path(__file__).parent)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
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
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-3000:]
    return np.load(d / "jax.npz"), got


def _grad_close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    gap = float(np.abs(got - want).max()) / scale
    assert gap < GRAD_GAP, (what, gap)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_local_dispatch_matches_the_reference(results, mesh):
    """Output, aux and every gradient (the input's too) of
    ``sum(y**2) + aux`` through the local dispatch."""
    jx, tx = results
    for k in ("y", "aux"):
        np.testing.assert_allclose(tx[f"moe/{mesh}/{k}"],
                                   jx[f"moe/{mesh}/{k}"], rtol=RTOL,
                                   atol=ATOL)
    grads = [k for k in jx.files if k.startswith(f"moe/{mesh}/grad/")]
    assert len(grads) == 8          # x, router, 3 experts, 3 shared
    for k in grads:
        _grad_close(tx[k], jx[k], k)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gather_dispatch_matches_the_reference(results, mesh):
    """The gather dispatch (the configs' default) on each rank's blocks
    gives the reference's partitioned gather path over the whole batch:
    output, aux and every gradient of ``sum(y**2) + aux``."""
    jx, tx = results
    for k in ("y", "aux"):
        np.testing.assert_allclose(tx[f"moe_gather/{mesh}/{k}"],
                                   jx[f"moe_gather/{mesh}/{k}"], rtol=RTOL,
                                   atol=ATOL)
    grads = [k for k in jx.files if k.startswith(f"moe_gather/{mesh}/grad/")]
    assert len(grads) == 8
    for k in grads:
        _grad_close(tx[k], jx[k], k)


def test_gather_dispatch_splits_experts_and_slots(results):
    """Under a mesh no rank runs the whole MoE: each runs its model rank's
    slice of the experts on its data rank's share of the capacity slots
    (the local dispatch: on its data shard's own buffer)."""
    _, tx = results
    E, k = MOE["n_experts"], MOE["top_k"]
    T = X_SHAPE[0] * X_SHAPE[1]
    for mesh, (n_dp, n_ep) in MESHES.items():
        for key, tokens in (("moe_gather", T), ("moe", T // n_dp)):
            c = max(8, (int(tokens * k / E * 1.25) + 7) // 8 * 8)
            slots = -(-c // n_dp) if key == "moe_gather" else c
            assert tx[f"{key}/{mesh}/buffer"].tolist() == [
                [E // n_ep, slots, MOE["d_model"]]], (key, mesh)


def test_local_dispatch_follows_the_data_shards(results):
    """On a mesh with a data axis the reference's local path routes each
    data shard alone (its capacity and aux): the router's gradient moves
    away from the (1, 2) mesh's, which is the gather path's."""
    jx, tx = results
    r12 = jx["moe/1x2/grad/router"]
    r21 = jx["moe/2x1/grad/router"]
    assert float(np.abs(r21 - r12).max()) / float(np.abs(r12).max()) > \
        GRAD_GAP
    _grad_close(tx["moe/2x1/grad/router"], r21, "router")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ssd_decode_runs_per_data_shard(results, mesh):
    """One decoded token on DTensors (``ssm._decode_per_shard``: each rank
    its rows, heads whole, the new state written back to the cache's
    placements) equals the decode on whole tensors."""
    _, tx = results
    for what in ("y", "S"):
        np.testing.assert_allclose(tx[f"ssd_decode/{mesh}/{what}"],
                                   tx[f"ssd_decode/{mesh}/plain_{what}"],
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_ssd_scan_runs_per_data_shard(results, mesh):
    """The SSD block under a mesh: each rank scans its data shard's rows
    only, and the output and every gradient of ``sum(y**2)`` match the
    reference's."""
    jx, tx = results
    assert tx[f"ssd/{mesh}/rows"].tolist() == [SSD_X_SHAPE[0]
                                               // MESHES[mesh][0]]
    np.testing.assert_allclose(tx[f"ssd/{mesh}/y"], jx[f"ssd/{mesh}/y"],
                               rtol=RTOL, atol=ATOL)
    grads = [k for k in jx.files if k.startswith(f"ssd/{mesh}/grad/")]
    assert len(grads) == 9          # x and the 8 leaves
    for k in grads:
        _grad_close(tx[k], jx[k], k)


@pytest.mark.parametrize("case", list(FLASH))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_flash_sharded_matches_the_reference(results, mesh, case):
    jx, tx = results
    key = f"flash/{mesh}/{case}"
    np.testing.assert_allclose(tx[f"{key}/o"], jx[f"{key}/o"], rtol=RTOL,
                               atol=ATOL)
    for n in ("dq", "dk", "dv"):
        _grad_close(tx[f"{key}/{n}"], jx[f"{key}/{n}"], f"{key}/{n}")
