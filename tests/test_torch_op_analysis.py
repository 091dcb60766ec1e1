"""The port's op-level cost analysis (``launch/op_analysis.py``) and
attribution (``launch/attribution.py``) against the JAX package's HLO
analysis.

* The counterpart of ``tests/test_hlo_analysis.py``'s sample: 8 products
  of (16, 32) x (32, 32) and 8 all-reduces of the (16, 32) f32 result, in
  a 2-rank gloo world: 8·2·16·32·32 flops, 8·2·2048 collective bytes
  (all-reduce counted twice), 8 collectives.
* Views, ``detach`` and allocations cost no bytes.
* Per-device counts on DTensors: on fake worlds of 2 and 4 ranks each
  rank counts its local products, not the logical ones; a functional
  gather and its wait count one gathered block of live bytes.
* ``flash_attention_traffic`` equals the reference's, and
  ``file_attributed_bytes`` over a partition of files sums to the total.

The whole-model flop parity with the reference's ``analyze_hlo`` is in
``tests/test_torch_op_parity.py``."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.launch.attribution import \
    flash_attention_traffic as jflash_traffic

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sample(rank, init, out):
    import torch.distributed as dist
    from repro_torch.distributed.collectives import all_reduce
    from repro_torch.launch.op_analysis import analyze_ops
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=2)
    x = torch.ones(16, 32)
    w = torch.full((32, 32), 0.5)

    def body():
        y = x
        for _ in range(8):
            y = all_reduce(y @ w, dist.group.WORLD) / 64
        return y
    c = analyze_ops(body)
    if rank == 0:
        torch.save({"flops": c.flops, "collective_bytes": c.collective_bytes,
                    "collectives": c.collectives}, out)
    dist.destroy_process_group()


def test_the_reference_sample_counts(tmp_path):
    """8 products and 8 all-reduces: the reference's numbers."""
    out = tmp_path / "sample.pt"
    torch.multiprocessing.spawn(_sample, args=(
        f"file://{tmp_path / 'store'}", str(out)), nprocs=2)
    c = torch.load(out)
    assert c["flops"] == 8 * 2 * 16 * 32 * 32
    assert c["collective_bytes"] == 8 * 2 * 2048
    assert c["collectives"] == {"all-reduce": {"count": 8,
                                               "bytes": 8 * 2 * 2048}}


def test_views_cost_no_bytes():
    """Views, ``detach`` and allocations move nothing; an elementwise op
    costs its operands plus its output."""
    from repro_torch.launch.op_analysis import analyze_ops
    x = torch.ones(8, 16)
    c = analyze_ops(lambda: (x.view(16, 8).t().detach()[:, 1:],
                             torch.empty(4, 4), x.reshape(2, 64)))
    assert (c.bytes, c.flops) == (0, 0)
    c = analyze_ops(lambda: x * 2.0)
    assert c.bytes == 2 * x.numel() * 4


_FAKE = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.op_analysis import analyze_ops
out = {}
for shape in ((1, 2), (2, 2)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 32), mesh,
                              (Shard(0), Replicate()), src_data_rank=None)
        w = distribute_tensor(torch.empty(32, 48), mesh,
                              (Replicate(), Shard(1)), src_data_rank=None
                              ).requires_grad_()
        w2 = distribute_tensor(torch.empty(48, 16), mesh,
                               (Replicate(), Shard(0)), src_data_rank=None)

        def step():
            y = (x @ w) @ w2
            y.full_tensor().sum().backward()
        c = analyze_ops(step)
    out["x".join(map(str, shape))] = [c.flops, c.collective_bytes]
    # a functional gather and its wait hold one gathered block
    from repro_torch.distributed.collectives import all_gather
    from repro_torch.launch.op_analysis import OpCounter
    with FakeTensorMode():
        part = torch.empty(256, 4)
        counter = OpCounter()
        counter.track(part)
        with counter:
            whole = all_gather(part, dist.group.WORLD)
        out["gather_peak/" + "x".join(map(str, shape))] = [
            counter.peak, counter.live, whole.numel() * 4, part.numel() * 4]
    dist.destroy_process_group()
json.dump(out, open(sys.argv[1], "w"))
"""


def _fake_world(tmp_path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", _FAKE, str(tmp_path / "o")],
                       env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    import json
    return json.loads((tmp_path / "o").read_text())


def test_dtensor_ops_count_each_rank_local_work(tmp_path):
    """``(x @ w) @ w2`` and w's gradient, x split over "data" and w, w2
    over "model": each rank counts its 4 local products (2 forward, the
    input's and w's gradients), the logical count over the mesh's size."""
    got = _fake_world(tmp_path)
    # x @ w and w's gradient: 2·64·32·48 each; (x @ w) @ w2 and the
    # gradient of x @ w: 2·64·48·16 each
    logical = 2 * (2 * 64 * 32 * 48) + 2 * (2 * 64 * 48 * 16)
    assert got["1x2"][0] == logical / 2
    assert got["2x2"][0] == logical / 4
    assert got["1x2"][1] > 0 and got["2x2"][1] > 0


def test_a_gather_and_its_wait_hold_one_block(tmp_path):
    """Under ``FakeTensorMode`` a functional all-gather's ``wait_tensor``
    makes a storage of its own (on a device it returns its input): the
    live bytes count the gathered block once, beside the part."""
    got = _fake_world(tmp_path)
    for shape in ("1x2", "2x2"):
        peak, live, whole, part = got["gather_peak/" + shape]
        assert whole == part * (2 if shape == "1x2" else 4)
        assert peak == live == part + whole


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("with_backward", [True, False])
def test_flash_attention_traffic_matches_the_reference(causal,
                                                       with_backward):
    from repro_torch.launch.attribution import flash_attention_traffic
    for args in [(1, 1, 256, 256, 64, 128, 2), (2, 8, 2048, 2048, 128, 256,
                                                 2),
                 (4, 3, 1024, 4096, 80, 128, 4), (8, 16, 512, 512, 256,
                                                  512, 2)]:
        kw = dict(causal=causal, with_backward=with_backward)
        assert flash_attention_traffic(*args, **kw) == \
            jflash_traffic(*args, **kw)


def test_file_attributed_bytes_partition_the_total(tmp_path, monkeypatch):
    """Ops of a step whose work runs in two files: the bytes attributed to
    each sum to the step's total, and a file the step never enters gets
    none."""
    from repro_torch.launch.attribution import file_attributed_bytes
    from repro_torch.launch.op_analysis import analyze_ops
    for name, body in (("part_a", "return (x * 2.0).sum(0)"),
                       ("part_b", "return x @ x.T")):
        (tmp_path / f"{name}.py").write_text(f"def f(x):\n    {body}\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    import part_a
    import part_b
    x = torch.ones(8, 16)

    def step():
        return part_a.f(x), part_b.f(x)
    total = analyze_ops(step).bytes
    a = file_attributed_bytes(step, "part_a.py")
    b = file_attributed_bytes(step, "part_b.py")
    assert a > 0 and b > 0 and a + b == total
    assert file_attributed_bytes(step, "no_such_file.py") == 0
