"""Device meshes over the ranks of a ``torch.distributed`` world.

Functions (not module-level constants), so importing never touches the
process group.  The production shapes are the JAX package's: a single pod
of 16 x 16 = 256 devices; multi-pod 2 x 16 x 16 = 512 with a leading
"pod" axis (which carries only data parallelism and gradient reduction).
The caller starts the world (``torchrun`` and
``torch.distributed.init_process_group``); a mesh needs exactly as many
ranks as it has cells.
"""

from __future__ import annotations

import math

import torch.distributed as dist

from ..device import resolve_device

__all__ = ["make_mesh", "make_production_mesh", "make_host_mesh",
           "DEVICES_PER_HOST"]

#: the JAX package's grouping of devices into hosts (its v5e hosts drive 4
#: chips each), which the checkpoint's per-host block sets follow; not a
#: fact about the card
DEVICES_PER_HOST = 4


def make_mesh(shape, axes, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    world's ranks in order, on the card unless ``device="cpu"`` is asked
    for (the counterpart of ``make_mesh_compat``)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"rank")
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the world first "
                           "(torchrun, torch.distributed."
                           "init_process_group)")
    n, world = math.prod(shape), dist.get_world_size()
    if n != world:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the world has "
                         f"{world}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_host_mesh(shape=None, axes=("data", "model"), device="cuda"):
    """Small mesh over whatever ranks exist (tests / examples): (1,
    world size) unless ``shape`` is given."""
    if shape is None:
        shape = (1, dist.get_world_size() if dist.is_initialized() else 1)
    return make_mesh(shape, axes, device)
