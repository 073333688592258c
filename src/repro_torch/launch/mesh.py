"""Production mesh builders, the port of ``repro.launch.mesh`` (functions,
not module-level constants: importing this module touches no process
group).

A :class:`Mesh` keeps the JAX package's axis names and sizes, so the
sharding policy (``repro_torch.distributed.sharding``) gives the same spec
trees, over a ``torch.distributed`` ``DeviceMesh``:

- ``make_production_mesh()``: (16, 16) ``("data", "model")``, 256 ranks;
- ``make_production_mesh(multi_pod=True)``: (2, 16, 16)
  ``("pod", "data", "model")``, 512 ranks.

On H100s that is 256 or 512 cards in nodes of 8: a model axis of 16 spans
two NVLink nodes, so its collectives cross the network between them.

Every DTensor of the port lives on one 2-D mesh, :attr:`Mesh.compute`: the
mesh itself when it has one data-parallel axis, else ``("dp", "model")``
with ``pod`` and ``data`` flattened into ``dp``, so that a leaf sharded over
``("pod", "data")`` (an FSDP gather, a batch) takes one collective over
the 32 data-parallel ranks, as XLA's does, not one a mesh dim.

:func:`fake_group` gives the dry-run a process group of the mesh's size in
one process (``torch``'s ``"fake"`` backend: collectives return at once and
move nothing) and destroys it afterwards.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

DP_AXES = ("pod", "data")


class Mesh:
    """Axis names and sizes (``shape``, a dict as ``jax.sharding.Mesh``'s)
    and, when built on a process group, the ``DeviceMesh`` with those
    names (``device_mesh``) and the 2-D mesh the DTensors live on
    (``compute``). Without a device type it is a shape only, the
    counterpart of ``jax.sharding.AbstractMesh`` (the spec functions need
    no more)."""

    def __init__(self, sizes: Sequence[int], axis_names: Sequence[str],
                 device_type: Optional[str] = None):
        sizes, axis_names = tuple(int(s) for s in sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or axis_names[-1] != "model":
            raise ValueError(f"a mesh is (..., model): got {axis_names} of "
                             f"{sizes}")
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        self.size = math.prod(sizes)
        self.dp = tuple(a for a in DP_AXES if a in axis_names)
        self.device_mesh = self.compute = None
        if device_type is not None:
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(device_type, sizes,
                                                mesh_dim_names=axis_names)
            if len(self.dp) > 1:
                self.device_mesh[self.dp]._flatten("dp")
                self.compute = self.device_mesh["dp", "model"]
            else:
                self.compute = self.device_mesh

    @property
    def dp_size(self) -> int:
        return math.prod(self.shape[a] for a in self.dp)

    def __repr__(self) -> str:
        where = "" if self.compute is None else \
            f", {self.compute.device_type}"
        return f"Mesh({self.shape}{where})"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = "cpu") -> Mesh:
    """(16, 16) ``("data", "model")``; ``multi_pod`` adds the 2-pod axis.
    Needs a process group of 256 (512) ranks unless ``device_type`` is
    None (a shape only)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device_type)


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: Optional[str] = "cpu") -> Mesh:
    return Mesh(shape, axes, device_type)


def make_local_mesh(device_type: Optional[str] = "cpu") -> Mesh:
    """A (1, 1) mesh with the production axis names (one rank)."""
    return Mesh((1, 1), ("data", "model"), device_type)


def mesh_arg(text: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``"DxM"`` or ``"PxDxM"`` as (sizes, axis names)."""
    dims = tuple(int(x) for x in text.lower().split("x"))
    if not 2 <= len(dims) <= 3 or min(dims) < 1:
        raise ValueError(f"a mesh is DxM or PxDxM, not {text!r}")
    return dims, ("pod", "data", "model")[-len(dims):]


@contextlib.contextmanager
def fake_group(world: int):
    """A process group of ``world`` ranks in this process, as rank 0, on
    torch's ``"fake"`` backend (no data moves; meant for ``meta`` tensors),
    destroyed on exit. Refuses to replace a group already initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
