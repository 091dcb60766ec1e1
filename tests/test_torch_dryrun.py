"""The port's dry run (``launch/dryrun.py``) on a fake world of 2 x 2
ranks (rank 0 of a ``fake`` process group, in a subprocess; the 2 x 2 x 2
world is ``tests/test_torch_dryrun_pod.py``'s): every smoke config at
every shape, cut to a small sequence and
batch of the same kinds, gives records with the JAX package's keys, ``ok``
where the reference's ``skip_reason`` gives none and ``skip`` with its
words where it gives one; the ``--flash``, ``--moe-local`` and ``--zero1``
variants run; and the flash custom ops' fake outputs have their plain
versions' shapes and dtypes.  The SSD decode on a data axis and the
decode into a KV cache split over its sequence (``long_500k``) run per
shard (``models/ssm._decode_per_shard``,
``models/attention._decode_seq_split``)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.configs import list_archs as jlist_archs
from repro.configs import shapes_for as jshapes_for
from repro.configs import skip_reason as jskip_reason

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: the reference's record keys (``src/repro/launch/dryrun.py`` run_cell)
OK_KEYS = {"arch", "shape", "variant", "mesh", "status", "lower_seconds",
           "compile_seconds", "chips", "memory", "hlo_flops_per_dev",
           "hlo_bytes_per_dev", "xla_reported_flops_per_dev",
           "xla_reported_bytes_per_dev", "while_trips", "collectives",
           "model_flops", "roofline", "useful_flop_ratio"}
SKIP_KEYS = {"arch", "shape", "variant", "mesh", "status", "reason"}
MEMORY_KEYS = {"argument_bytes_per_dev", "output_bytes_per_dev",
               "temp_bytes_per_dev", "alias_bytes_per_dev",
               "peak_bytes_per_dev"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant"}
MESHES = {"2x2": ((2, 2), ("data", "model"))}
#: small cells of the registered kinds: (seq_len, global_batch)
SMALL = {"train": (32, 8), "prefill": (32, 8), "decode": (32, 8)}

_WORLD = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import get_smoke_config, list_archs, shapes_for
from repro_torch.configs.common import ShapeCell
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_mesh
shape, axes, small, variants = (json.loads(a) for a in sys.argv[2:6])
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size=int(torch.tensor(shape).prod()))
mesh = make_mesh(shape, axes, "cpu")
out = []
jobs = [(a, s.name, s.kind, s.global_batch, {}, False)
        for a in small.pop("archs", list_archs()) for s in shapes_for(a)
        if s.kind in small] + [
    tuple(v) for v in variants]
for arch, name, kind, batch, overrides, zero1 in jobs:
    seq, b = small[kind]
    cell = ShapeCell(name, kind, seq, 1 if batch == 1 else b)
    cfg = dataclasses.replace(get_smoke_config(arch), flash_block=32,
                              loss_chunk=32)
    rec = run_cell(arch, name, mesh, len(shape) == 3, zero1=zero1,
                   overrides=dict(overrides), cfg=cfg, shape=cell,
                   variant="+".join(sorted(overrides)) or
                   ("zero1" if zero1 else "baseline"))
    rec.pop("traceback", None)
    out.append(rec)
json.dump(out, open(sys.argv[1], "w"))
"""

#: variant runs: (arch, shape, kind, batch, overrides, zero1)
VARIANTS = [("qwen2.5-3b", "train_4k", "train", 4, {"flash": True}, False),
            ("deepseek-moe-16b", "train_4k", "train", 4,
             {"moe_dispatch": "local"}, False),
            ("qwen2.5-3b", "train_4k", "train", 4, {}, True)]


def run_worlds(meshes: dict, variants: list, d, small=None) -> dict:
    """Each mesh's records, from a fake world in a subprocess each;
    ``small`` maps a mesh's tag to its cells' sizes by kind (``SMALL``
    else; the kinds it leaves out are not run) and, under ``"archs"``,
    the archs to run (all else)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")       # the worlds share the host
    procs = {tag: subprocess.Popen(
        [sys.executable, "-c", _WORLD, str(d / f"{tag}.json"),
         json.dumps(shape), json.dumps(axes),
         json.dumps((small or {}).get(tag, SMALL)),
         json.dumps(variants)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for tag, (shape, axes) in meshes.items()}
    out = {}
    for tag, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        out[tag] = json.loads((d / f"{tag}.json").read_text())
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    return run_worlds(MESHES, VARIANTS, tmp_path_factory.mktemp("dryrun"))


def check_keys(recs, chips: int) -> None:
    """Every ``ok`` record has the reference's keys, every ``skip`` record
    exactly the reference's."""
    for rec in recs:
        if rec["status"] == "ok":
            assert OK_KEYS <= set(rec), rec["arch"]
            assert set(rec["memory"]) == MEMORY_KEYS
            assert set(rec["roofline"]) == ROOFLINE_KEYS
            assert rec["compile_seconds"] is None
            assert rec["xla_reported_flops_per_dev"] is None
            assert rec["while_trips"] == {}
            assert rec["chips"] == chips
            assert rec["hlo_flops_per_dev"] > 0
            assert rec["memory"]["peak_bytes_per_dev"] >= \
                rec["memory"]["argument_bytes_per_dev"]
        elif rec["status"] == "skip":
            assert set(rec) == SKIP_KEYS


def check_status(recs) -> None:
    """``ok`` where the reference's ``skip_reason`` is None, ``skip`` with
    its words where it is not."""
    got = {(r["arch"], r["shape"]): r for r in recs
           if r["variant"] == "baseline"}
    assert set(got) == {(a, s.name) for a in jlist_archs()
                        for s in jshapes_for(a)}
    for (arch, shape), rec in got.items():
        reason = jskip_reason(arch, shape)
        if reason:
            assert (rec["status"], rec["reason"]) == ("skip", reason)
        else:
            assert rec["status"] == "ok", (arch, shape, rec.get("error"))


def test_records_keep_the_reference_keys(records):
    check_keys(records["2x2"], 4)


def test_ok_and_skip_follow_the_reference(records):
    check_status(records["2x2"])


def test_variants_run(records):
    """``--flash`` (the flash custom ops under the fake trace),
    ``--moe-local`` and ``--zero1``."""
    recs = [r for r in records["2x2"] if r["variant"] != "baseline"]
    assert [r["variant"] for r in recs] == ["flash", "moe_dispatch",
                                            "zero1"]
    assert all(r["status"] == "ok" for r in recs), recs
    base = next(r for r in records["2x2"] if r["variant"] == "baseline"
                and (r["arch"], r["shape"]) == ("qwen2.5-3b", "train_4k"))
    zero1 = recs[2]
    # the same step; each rank holds half of the moments
    assert zero1["hlo_flops_per_dev"] == base["hlo_flops_per_dev"]
    assert zero1["memory"]["argument_bytes_per_dev"] < \
        base["memory"]["argument_bytes_per_dev"]


def test_flash_custom_ops_fake_shapes_match_the_plain_outputs():
    """Under ``FakeTensorMode`` the forward, dq and dkv custom ops give
    their plain versions' output shapes and dtypes (GQA, bf16 and f32)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    import repro_torch.kernels.flash_attention  # noqa: F401 - the ops
    ops = torch.ops.repro_torch
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(0)
        q = torch.randn(2, 4, 48, 16, generator=g).to(dtype)
        k = torch.randn(2, 2, 40, 16, generator=g).to(dtype)
        v = torch.randn(2, 2, 40, 16, generator=g).to(dtype)
        args = (0.25, True, None, None)
        o, lse = ops.flash_fwd(q, k, v, *args)
        do = torch.randn_like(o)
        delta = (do.float() * o.float()).sum(-1)
        bwd = (q, k, v, do, lse, delta) + args
        real = [o, lse, ops.flash_dq(*bwd), *ops.flash_dkv(*bwd)]
        with FakeTensorMode(allow_non_fake_inputs=True) as fm:
            fq, fk, fv, fdo, flse, fdelta = (fm.from_tensor(t) for t in
                                             (q, k, v, do, lse, delta))
            fo, fl = ops.flash_fwd(fq, fk, fv, *args)
            fb = (fq, fk, fv, fdo, flse, fdelta) + args
            fake = [fo, fl, ops.flash_dq(*fb), *ops.flash_dkv(*fb)]
        assert [(t.shape, t.dtype) for t in fake] == \
            [(t.shape, t.dtype) for t in real]
