"""The port's sharding policy (``repro_torch.distributed.sharding``) against
the JAX package's (``repro.distributed.sharding``): the spec trees of
``param_pspecs`` (FSDP on and off), ``batch_pspecs``, ``cache_pspecs`` and
``train_state_pspecs`` are equal, leaf for leaf, for all ten registry
architectures at their full and smoke configs, on the (1, 1), (16, 16) and
(2, 16, 16) meshes and on a (2, 3) mesh whose model axis divides almost
nothing. The JAX side runs on ``jax.sharding.AbstractMesh``, the port's on
its shape-only ``launch.mesh.Mesh`` (no process group): both need only the
axis names and sizes. The per-device parameter bytes that the port's
DTensor placements give equal the count from the JAX specs. Exact
equality throughout: these are integers and names.
"""
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import registry as JR
from repro.configs.shapes import ALL_SHAPES as J_SHAPES
from repro.distributed import sharding as jsh
from repro.models import model as JM
from repro.models import params as JP
from repro.train import data as jdata
from repro_torch.configs import registry as TR
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import model as TM
from repro_torch.models import params as TP
from repro_torch.train import data as tdata

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x3": ((2, 3), ("data", "model"))}


def jax_flat(tree):
    """{path: spec entries as a tuple} of a JAX spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(str(getattr(k, "key", getattr(k, "name", k)))
                  for k in path): tuple(spec) for path, spec in leaves}


def port_flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in port_flat(sub, path + (str(key),)).items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: v for f in tree._fields
                for k, v in port_flat(getattr(tree, f), path + (f,)).items()}
    assert isinstance(tree, sh.Spec), tree
    return {path: tuple(tree)}


def meshes(name):
    sizes, axes = MESHES[name]
    return AbstractMesh(sizes, axes), Mesh(sizes, axes)


def configs(arch):
    return ((JR.ARCHS[arch].config, TR.ARCHS[arch].config),
            (JR.ARCHS[arch].smoke, TR.ARCHS[arch].smoke))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(JR.ARCHS))
def test_param_and_train_state_specs_equal_jax(arch, mesh):
    jmesh, tmesh = meshes(mesh)
    for jcfg, tcfg in configs(arch):
        assert sh.ep_enabled(tcfg, tmesh) == jsh.ep_enabled(jcfg, jmesh)
        for fsdp in (True, False):
            assert port_flat(sh.param_pspecs(tcfg, tmesh, fsdp=fsdp)) == \
                jax_flat(jsh.param_pspecs(jcfg, jmesh, fsdp=fsdp))
        assert port_flat(sh.train_state_pspecs(tcfg, tmesh)) == \
            jax_flat(jsh.train_state_pspecs(jcfg, jmesh))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(JR.ARCHS))
def test_batch_and_cache_specs_equal_jax(arch, mesh):
    """Every registry shape's batch (train / prefill / decode) and decode
    cache, at the full config; the smoke config at small sizes (batch 1,
    2, 6 and caches of 16 and 48 slots)."""
    jmesh, tmesh = meshes(mesh)
    (jcfg, tcfg), (jsm, tsm) = configs(arch)
    cases = [(jcfg, tcfg, s.seq_len, s.global_batch, s.kind)
             for s in J_SHAPES.values()]
    cases += [(jsm, tsm, s, b, kind) for s, b in ((16, 1), (48, 2), (16, 6))
              for kind in ("train", "prefill", "decode")]
    for jc, tc, s, b, kind in cases:
        jb, tb = (jdata.batch_specs(jc, s, b, kind),
                  tdata.batch_specs(tc, s, b, kind))
        assert port_flat(sh.batch_pspecs(tc, tmesh, tb, b)) == \
            jax_flat(jsh.batch_pspecs(jc, jmesh, jb, b)), (kind, s, b)
        if kind == "decode":
            jcache, tcache = JM.cache_specs(jc, b, s), TM.cache_specs(tc, b, s)
            assert port_flat(sh.cache_pspecs(tc, tmesh, tcache, b)) == \
                jax_flat(jsh.cache_pspecs(jc, jmesh, jcache, b)), (s, b)


def _local_shape(mesh, shape, spec):
    """A leaf's local shape from the port's DTensor placements on the
    compute mesh (data-parallel dim, model dim)."""
    from torch.distributed.tensor import Shard

    sizes = (mesh.dp_size, mesh.shape["model"])
    out = list(shape)
    for size, p in zip(sizes, sh.placements(mesh, spec)):
        if isinstance(p, Shard):
            assert out[p.dim] % size == 0
            out[p.dim] //= size
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(JR.ARCHS))
def test_per_device_parameter_bytes_equal_the_jax_specs(arch, mesh):
    """float32 parameter bytes a device: the port's placements (local
    shapes) against the JAX specs' count (each leaf over the sizes of the
    axes its spec names), FSDP on and off."""
    jmesh, tmesh = meshes(mesh)
    jcfg, tcfg = configs(arch)[0]
    shapes = TP.param_specs(tcfg)
    for fsdp in (True, False):
        jspecs = jsh.param_pspecs(jcfg, jmesh, fsdp=fsdp)
        want = sum(
            4 * int(np.prod(x.shape)) // math.prod(
                jsh.axis_size(jmesh, e) for e in spec)
            for x, spec in zip(jax.tree_util.tree_leaves(JP.param_specs(jcfg)),
                               jax.tree_util.tree_leaves(
                                   jspecs, is_leaf=lambda s: isinstance(
                                       s, jax.sharding.PartitionSpec))))
        specs = sh.param_pspecs(tcfg, tmesh, fsdp=fsdp)
        got = []
        sh._map(lambda _, t, s: got.append(
            4 * math.prod(_local_shape(tmesh, t.shape, s))), shapes, specs)
        assert sum(got) == want


def test_spec_entries_and_placements():
    """``Spec`` compares as the JAX ``PartitionSpec``'s tuple (1-tuples are
    their name) and pickles; placements follow the compute mesh: the data
    axes (flattened on a multi-pod mesh) first, "model" second, both for a
    sequence split over data and model; a split over "data" alone on a
    multi-pod mesh is refused."""
    import pickle

    from torch.distributed.tensor import Replicate, Shard

    assert sh.Spec(("data",), "model") == tuple(
        jax.sharding.PartitionSpec(("data",), "model"))
    assert pickle.loads(pickle.dumps(sh.Spec(("pod", "data"), None))) == \
        sh.Spec(("pod", "data"), None)
    one = Mesh((16, 16), ("data", "model"))
    two = make_production_mesh(multi_pod=True, device_type=None)
    assert sh.placements(one, sh.Spec(None, "data", "model")) == (
        Shard(1), Shard(2))
    assert sh.placements(two, sh.Spec(("pod", "data"))) == (Shard(0),
                                                            Replicate())
    assert sh.placements(one, sh.Spec(None, ("data", "model"))) == (
        Shard(1), Shard(1))
    with pytest.raises(ValueError, match="alone"):
        sh.placements(two, sh.Spec("data"))
    assert two.dp == ("pod", "data") and two.dp_size == 32
    assert two.compute is None and two.size == 512


def test_sharded_init_equals_init_params_on_one_rank(tmp_path):
    """``sharding.init_params`` on a (1, 1) gloo mesh of one rank: every
    leaf a DTensor holding ``params.init_params``'s values for the same
    seed, bit for bit (the slab draw order is the same), also for a leaf
    drawn in several slabs."""
    import torch.distributed as dist

    from repro_torch.models import params as Pm

    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = Mesh((1, 1), ("data", "model"), "cpu")
        cfg = TR.ARCHS["qwen2-moe-a2.7b"].smoke
        old = Pm._DRAW_CHUNK
        Pm._DRAW_CHUNK = 1 << 10  # several slabs a leaf
        try:
            want = Pm.init_params(cfg, torch.Generator().manual_seed(3),
                                  device="cpu")
            got = sh.init_params(cfg, torch.Generator().manual_seed(3),
                                 mesh, device="cpu")
        finally:
            Pm._DRAW_CHUNK = old
        for a, b in zip(Pm.tree_leaves(got), Pm.tree_leaves(want)):
            assert torch.equal(a.to_local(), b)
    finally:
        dist.destroy_process_group()
