"""Sharding policy, the port of ``repro.distributed.sharding``: logical
parameter axes -> mesh specs -> DTensor placements.

Mesh axes: ("pod",) "data", "model".
  - fsdp: weight dim sharded over all data-parallel axes (ZeRO-3);
  - tp:   weight dim sharded over the model axis;
  - ep:   expert dim over the model axis when the expert count divides it,
          otherwise experts stay replicated and their ff dim ("etp") takes
          the model axis (expert-internal tensor parallelism) — this keeps
          e.g. Mixtral's 8 experts valid on a 16-way model axis.
A dimension the axis size does not divide stays unsharded.

Activations: batch over the data axes; KV cache prefers kv-heads over the
model axis, falling back to the sequence dim when kv-heads don't divide it
(GQA with few kv heads, e.g. chatglm3's kv=2), and to data+model on the
sequence for long-context decode.

A :class:`Spec` is the port's ``PartitionSpec``: one entry per dim, each
``None``, an axis name or a tuple of names (a 1-tuple is its name, as in
JAX), trailing ``None``s cut; it equals the JAX spec's entries as a tuple.
:func:`named` maps a spec onto DTensor placements of ``Mesh.compute``,
:func:`distribute` places a tree, :func:`init_params` draws each rank's
shards of ``models.params.init_params`` without the whole model.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.models import params as Pm
from repro_torch.models.config import ModelConfig


class Spec(tuple):
    """``Spec("model", None, ("pod", "data"))``; see the module docstring."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "Spec" + tuple.__repr__(self)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and not isinstance(x, Spec) and all(
        isinstance(e, (str, type(None))) for e in x)


def _map(fn, *trees, is_leaf=lambda x: False, path=()):
    """``fn(path, *leaves)`` over trees of dicts and NamedTuples."""
    t = trees[0]
    if not is_leaf(t):
        if isinstance(t, dict):
            return {k: _map(fn, *(u[k] for u in trees), is_leaf=is_leaf,
                            path=path + (k,)) for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*[_map(fn, *(getattr(u, f) for u in trees),
                                  is_leaf=is_leaf, path=path + (f,))
                             for f in t._fields])
    return fn(path, *trees)


def dp_axes(mesh: Mesh):
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def ep_enabled(cfg: ModelConfig, mesh: Mesh) -> bool:
    m = mesh.shape["model"]
    return cfg.moe_experts > 0 and cfg.moe_experts % m == 0


def _leaf_spec(mesh: Mesh, fsdp: bool, ep: bool, dp, shape, axes) -> Spec:
    """One parameter's spec from its logical axes."""
    def to_mesh_axes(logical):
        if logical == "fsdp":
            return dp if fsdp else None
        if logical == "tp":
            return "model"
        if logical == "ep":
            return "model" if ep else None
        if logical == "etp":
            return None if ep else "model"
        return None

    mesh_axes = []
    for dim, logical in zip(shape, axes):
        ma = to_mesh_axes(logical)
        if ma is not None and dim % axis_size(mesh, ma) != 0:
            ma = None  # don't shard indivisible dims (explicit > padded)
        mesh_axes.append(ma)
    while mesh_axes and mesh_axes[-1] is None:
        mesh_axes.pop()
    return Spec(*mesh_axes)


def param_pspecs(cfg: ModelConfig, mesh: Mesh, fsdp: bool = True):
    """Spec tree matching the param tree."""
    ep, dp = ep_enabled(cfg, mesh), dp_axes(mesh)
    return _map(lambda _, axes, sds: _leaf_spec(mesh, fsdp, ep, dp,
                                                sds.shape, axes),
                Pm.param_axes(cfg), Pm.param_specs(cfg), is_leaf=_is_axes)


def batch_pspecs(cfg: ModelConfig, mesh: Mesh, batch_specs_tree,
                 global_batch: int):
    """Input batch sharding: leading batch dim over the data axes."""
    dp = dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    baxes = dp if global_batch % dp_n == 0 else (
        dp[-1] if global_batch % mesh.shape[dp[-1]] == 0 else None)

    return _map(lambda _, t: Spec() if t.ndim == 0 else Spec(baxes),
                batch_specs_tree)


def cache_pspecs(cfg: ModelConfig, mesh: Mesh, cache_specs_tree,
                 batch: int):
    """Decode-cache sharding (leaves stacked (nb, B, ...))."""
    dp = dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    m = mesh.shape["model"]
    baxes = dp if batch % dp_n == 0 else None
    kv_heads_shardable = cfg.n_kv_heads % m == 0

    def spec_path(path, sds):
        name = path[-1]
        if name in ("k", "v"):
            # (nb, B, S, Hkv, hd)
            if kv_heads_shardable:
                return Spec(None, baxes, None, "model", None)
            s = sds.shape[2]
            seq_ax = "model" if s % m == 0 else None
            if baxes is None and seq_ax is not None and s % (m * dp_n) == 0:
                # long-context decode: sequence-parallel over data+model
                return Spec(None, None, (*dp, "model"), None, None)
            return Spec(None, baxes, seq_ax, None, None)
        if name == "ssm":
            # (nb, B, H, P, N)
            h = sds.shape[2]
            return Spec(None, baxes, "model" if h % m == 0 else None, None,
                        None)
        if name in ("conv_x",):
            c = sds.shape[-1]
            return Spec(None, baxes, None, "model" if c % m == 0 else None)
        return Spec(None, baxes)

    return _map(spec_path, cache_specs_tree)


def train_state_pspecs(cfg: ModelConfig, mesh: Mesh, fsdp: bool = True):
    """TrainState sharding: params, and m/v like params; step replicated."""
    from repro_torch.train.optimizer import AdamWState
    from repro_torch.train.train_step import TrainState

    p = param_pspecs(cfg, mesh, fsdp=fsdp)
    return TrainState(params=p, opt=AdamWState(step=Spec(), m=p, v=p))


# -- specs as DTensor placements ---------------------------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``placements`` on ``mesh.compute`` (data-parallel
    dim first, model second)."""

    mesh: Mesh
    spec: Spec

    @property
    def device_mesh(self):
        return self.mesh.compute

    @property
    def placements(self):
        return placements(self.mesh, self.spec)


def placements(mesh: Mesh, spec) -> tuple:
    """``spec``'s DTensor placements on ``mesh.compute``: a tensor dim
    sharded over every data-parallel axis is ``Shard`` on the first
    compute dim, over ``"model"`` on the second (both, in that order, for
    a ``(*dp, "model")`` entry); the rest is ``Replicate``."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate(), Replicate()]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        dp = tuple(a for a in names if a != "model")
        if dp:
            if dp != mesh.dp:
                raise ValueError(
                    f"{spec}: sharding over {dp} alone is not a dim of the "
                    f"compute mesh (data-parallel axes {mesh.dp})")
            out[0] = Shard(dim)
        if "model" in names:
            out[1] = Shard(dim)
    return tuple(out)


def grad_placements(placements, split):
    """The placements of the gradient a ``local_map`` body gives an input
    placed at ``placements``, when the body's work is split over the mesh
    dims where ``split`` is true: on such a dim a replicated input's
    gradient is each rank's share of a sum (``Partial``)."""
    from torch.distributed.tensor import Partial, Replicate

    return tuple(Partial() if s and isinstance(p, Replicate) else p
                 for p, s in zip(placements, split))


def named(mesh: Mesh, spec_tree):
    return _map(lambda _, s: NamedSharding(mesh, s), spec_tree,
                is_leaf=lambda x: isinstance(x, Spec))


def place(t: torch.Tensor, sharding: NamedSharding):
    """One tensor that every rank holds whole (or a ``meta`` tensor) as a
    DTensor: each rank keeps its own slices; nothing is sent."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(sharding.device_mesh, sharding.placements)
    return distribute_tensor(t, sharding.device_mesh, sharding.placements,
                             src_data_rank=None)


def distribute(tree, mesh: Mesh, specs):
    """``tree`` (every rank holding the same values, or ``meta``) placed
    as ``specs`` say: a tree of DTensors."""
    return _map(lambda _, t, s: place(t, NamedSharding(mesh, s)), tree,
                specs)


def local_slices(shape, sharding):
    """This rank's slice of a tensor of ``shape`` placed by ``sharding`` (a
    :class:`NamedSharding`, or anything with ``device_mesh`` and
    ``placements``, a DTensor too): a tuple of ``slice``s, one a dim."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, offset = compute_local_shape_and_global_offset(
        tuple(shape), sharding.device_mesh, sharding.placements)
    return tuple(slice(o, o + n) for o, n in zip(offset, local))


def from_local(local: torch.Tensor, shape, sharding):
    """A DTensor of global ``shape`` from this rank's ``local`` slice."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, sharding.device_mesh,
                              sharding.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(
                                  shape, device="meta").stride())


def zeros(tree, mesh: Mesh, specs, device=None):
    """DTensors of zeros shaped and typed as ``tree``'s leaves (``meta``
    tensors will do), placed by ``specs``: each rank allocates only its
    slices."""
    def leaf(_, t, spec):
        sharding = NamedSharding(mesh, spec)
        local = tuple(s.stop - s.start for s in local_slices(t.shape,
                                                             sharding))
        return from_local(torch.zeros(local, dtype=t.dtype,
                                      device=Pm.resolve_device(device)),
                          t.shape, sharding)
    return _map(leaf, tree, specs)


def init_cache(cfg: ModelConfig, mesh: Mesh, batch: int, s_max: int,
               dtype=None, device=None):
    """``models.model.init_cache`` placed by :func:`cache_pspecs`."""
    from repro_torch.models import model as M

    meta = M.cache_specs(cfg, batch, s_max, dtype)
    return zeros(meta, mesh, cache_pspecs(cfg, mesh, meta, batch), device)


def init_params(cfg: ModelConfig, generator: torch.Generator, mesh: Mesh,
                fsdp: bool = True, dtype=torch.float32, device=None):
    """``models.params.init_params(cfg, generator, dtype, device)`` as
    DTensors placed by ``param_pspecs(cfg, mesh, fsdp)``, equal to it value
    for value: every rank draws each leaf's slabs in the same order from
    its copy of the generator (the same seed on every rank) and keeps only
    its slice of each slab. No rank holds more than its shards and one
    slab (``params._DRAW_CHUNK`` float32 values)."""
    ep, dp = ep_enabled(cfg, mesh), dp_axes(mesh)

    def shard(shape, axes):
        sharding = NamedSharding(mesh, _leaf_spec(mesh, fsdp, ep, dp, shape,
                                                  axes))
        return (local_slices(shape, sharding),
                lambda local: from_local(local, shape, sharding))

    return Pm.init_params(cfg, generator, dtype=dtype, device=device,
                          shard=shard)
