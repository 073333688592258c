"""Dry-run of the sharded LM, the port of ``repro.launch.dryrun``: trace
every (architecture x input-shape x mesh) cell at the full registry config
on ``meta`` tensors (nothing is allocated), placed as
``distributed.sharding`` says, on a process group of the mesh's size in one
process (torch's ``"fake"`` backend, ``launch.mesh.fake_group``), under
``distributed.context.activation_sharding``, and write one JSON a cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-130m \\
        --shape train_4k [--multi-pod] [--all] [--analysis] \\
        [--out build/dryrun_torch]

A cell's JSON keeps the JAX layout where the meaning is the same: ``arch``,
``shape``, ``multi_pod``, ``analysis``, ``mesh``, ``kind``, ``params``,
``active_params`` and ``skipped`` (``registry.shape_applicable``'s reason),
and:

- ``lower_s``: seconds to trace the step (there is no compile);
- ``flops``: floating-point operations of ONE device (rank 0), counted on
  the local ops that DTensor runs on its shards (``torch.utils.
  flop_counter``'s formulas), not on the global program — DTensor's own
  shape propagation, which runs ops at global shapes, is left out;
- ``bytes_accessed``: the unfused per-op input + output bytes of the local
  ops (views excepted), which is NOT XLA's fused count;
- ``collectives``: ``{kind: {count, bytes}}`` under the JAX kind names
  (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``),
  read from the ``_c10d_functional`` ops' per-device outputs;
- ``argument_size_in_bytes`` / ``output_size_in_bytes``: the local shards
  of the step's inputs (state or params, batch, cache) and outputs (the
  state and cache are updated in place, so they count again as outputs);
  ``spec_argument_bytes`` is the same count from the spec trees alone.

Left out, because the port cannot measure them honestly on a trace:
``compile_s`` (nothing compiles), ``temp_size_in_bytes``,
``alias_size_in_bytes`` and ``generated_code_size_in_bytes`` (XLA buffer
assignment and code generation have no counterpart).

The analysis mode (``analyze_cell``) traces 1 and 2 blocks at
microbatches 1 and extrapolates to the full depth, as the JAX one does
(``depth_points``). The port's blocks are a Python loop, so the plain
trace already counts every layer: it also traces the full depth
(``full_depth``), states whether the extrapolation equals it
(``extrapolation_exact``) and by how much it misses
(``extrapolation_minus_full``).

Output goes under ``build/dryrun_torch/``; ``results/dryrun`` (the JAX
package's) is refused.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Optional

import torch

from repro_torch.configs import registry
from repro_torch.configs.shapes import ALL_SHAPES
from repro_torch.distributed import context as dctx
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.moe_spmd import make_spmd_moe
from repro_torch.launch.mesh import fake_group, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import params as Pm
from repro_torch.serve import decode as serve
from repro_torch.train import data as data_lib
from repro_torch.train import train_step as ts
from repro_torch.train.optimizer import AdamW

DEFAULT_OUT = os.path.join("build", "dryrun_torch")
KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all"}
_UNCOUNTED = ("empty", "empty_strided", "empty_like", "detach", "alias",
              "_local_scalar_dense", "wait_tensor", "_wrap_tensor_autograd",
              "lift_fresh")


def _tensor_bytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


def _flat_tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _flat_tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat_tensors(v)]
    return []


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor leaf of ``tree``."""
    from torch.distributed.tensor import DTensor

    leaves = []
    sh._map(lambda _, t: leaves.append(t), tree)
    return sum(_tensor_bytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in leaves if isinstance(t, torch.Tensor))


def _spec_bytes(mesh, tree, specs) -> int:
    """The same count from the spec trees: each leaf's bytes over the mesh
    axes its spec shards it on."""
    total = []

    def leaf(_, t, spec):
        parts = math.prod(sh.axis_size(mesh, e) for e in spec)
        total.append(t.numel() * t.element_size() // parts)
    sh._map(leaf, tree, specs)
    return sum(total)


class LocalOpCounter:
    """A dispatch mode that sees the local ops DTensor runs on rank 0's
    shards (it steps aside for DTensor-level calls, so DTensor runs them
    and their local ops come back through it) and counts their flops,
    unfused bytes and the collectives' kinds and output bytes."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, int]] = {}
        self.paused = 0

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if not counter.paused:
                    counter._count(func, args, kwargs, out, flop_registry)
                return out

        self.mode = Mode()

    def _count(self, func, args, kwargs, out, flop_registry) -> None:
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            kind = KINDS.get(name)
            if kind is not None:
                ent = self.collectives.setdefault(kind,
                                                  {"count": 0, "bytes": 0})
                ent["count"] += 1
                ent["bytes"] += sum(map(_tensor_bytes, _flat_tensors(out)))
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if func.is_view or name in _UNCOUNTED:
            return
        self.bytes += sum(map(_tensor_bytes, _flat_tensors(args)
                              + _flat_tensors(kwargs) + _flat_tensors(out)))

    @contextlib.contextmanager
    def counting(self):
        """Count inside; DTensor's shape propagation (ops it runs at the
        global shapes to learn an output's shape) is left out."""
        from torch.distributed.tensor import DTensor

        prop = DTensor._op_dispatcher.sharding_propagator
        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(prop, name)

        def quiet(*a, **k):
            self.paused += 1
            try:
                return orig(*a, **k)
            finally:
                self.paused -= 1

        setattr(prop, name, quiet)
        try:
            with self.mode:
                yield self
        finally:
            delattr(prop, name)

    def result(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "coll": {k: dict(v) for k, v in self.collectives.items()}}


def _check_counter(mesh) -> None:
    """x (4 dp, 64) @ W (64, 64 m) with x row-sharded and W column-sharded
    is 2 * 4 * 64 * 64 flops on each device: the counter must see that,
    not the global product (it fails if DTensor's dispatch hides its
    local ops, or counts a global op, in this torch release)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    dp, m = mesh.dp_size, mesh.shape["model"]
    x = distribute_tensor(torch.empty(4 * dp, 64, device="meta"),
                          mesh.compute, [Shard(0), Replicate()])
    w = distribute_tensor(torch.empty(64, 64 * m, device="meta"),
                          mesh.compute, [Replicate(), Shard(1)])
    c = LocalOpCounter()
    with c.counting():
        x @ w
    want = 2 * 4 * 64 * 64
    if c.flops != want:
        raise RuntimeError(f"the local-op counter saw {c.flops} flops of "
                           f"a {want}-flop local product")


def _logits_spec(cfg, mesh, batch: int) -> sh.Spec:
    dpa = sh.dp_axes(mesh)
    ok = batch % sh.axis_size(mesh, dpa) == 0
    vok = cfg.vocab % mesh.shape["model"] == 0
    return sh.Spec(dpa if ok else None, "model" if vok else None)


def _trace(cfg, shape, mesh, microbatches: int, fsdp: bool) -> dict:
    """Trace one step of ``shape.kind`` on ``mesh``; the counts, the
    argument and output bytes, and the trace seconds."""
    moe_impl = make_spmd_moe(cfg, mesh) if cfg.moe_experts else None
    counter = LocalOpCounter()
    b = shape.global_batch
    t0 = time.perf_counter()
    with dctx.activation_sharding(mesh):
        if shape.kind == "train":
            opt = AdamW()
            step = ts.make_train_step(cfg, opt, microbatches=microbatches,
                                      remat=True, moe_impl=moe_impl)
            state_meta = ts.train_state_specs(cfg, opt)
            state_specs = sh.train_state_pspecs(cfg, mesh, fsdp=fsdp)
            state = sh.distribute(state_meta, mesh, state_specs)
            batch_meta = data_lib.batch_specs(cfg, shape.seq_len, b, "train")
            batch_specs = sh.batch_pspecs(cfg, mesh, batch_meta, b)
            batch = sh.distribute(batch_meta, mesh, batch_specs)
            args = (state, batch)
            spec_bytes = (_spec_bytes(mesh, state_meta, state_specs)
                          + _spec_bytes(mesh, batch_meta, batch_specs))
            with counter.counting():
                out = step(state, batch)
        else:
            pdt = getattr(torch, cfg.dtype)  # serving keeps bf16 params
            p_meta = Pm.param_specs(cfg, dtype=pdt)
            p_specs = sh.param_pspecs(cfg, mesh, fsdp=False)
            params = sh.distribute(p_meta, mesh, p_specs)
            cache_meta = M.cache_specs(cfg, b, shape.seq_len)
            cache_specs = sh.cache_pspecs(cfg, mesh, cache_meta, b)
            cache = sh.zeros(cache_meta, mesh, cache_specs, device="meta")
            spec_bytes = (_spec_bytes(mesh, p_meta, p_specs)
                          + _spec_bytes(mesh, cache_meta, cache_specs))
            if shape.kind == "prefill":
                step = serve.make_prefill_step(cfg, moe_impl=moe_impl)
                batch_meta = data_lib.batch_specs(cfg, shape.seq_len, b,
                                                  "prefill")
            else:
                step = serve.make_decode_step(cfg, moe_impl=moe_impl)
                batch_meta = {"tokens": torch.empty((b, 1), dtype=torch.int32,
                                                    device="meta")}
            batch_specs = sh.batch_pspecs(cfg, mesh, batch_meta, b)
            batch = sh.distribute(batch_meta, mesh, batch_specs)
            spec_bytes += _spec_bytes(mesh, batch_meta, batch_specs)
            with torch.no_grad(), counter.counting():
                if shape.kind == "prefill":
                    args = (params, batch, cache)
                    out = step(params, batch, cache)
                else:
                    # the last slot: the step reads the whole cache
                    args = (params, cache, batch["tokens"])
                    out = step(params, cache, batch["tokens"],
                               shape.seq_len - 1)
    return dict(counter.result(), lower_s=time.perf_counter() - t0,
                argument_size_in_bytes=_local_bytes(dict(enumerate(args))),
                output_size_in_bytes=_local_bytes(dict(enumerate(out))),
                spec_argument_bytes=spec_bytes)


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               fsdp: bool = True, donate: bool = True,
               analysis: bool = False, cfg=None, mesh_shape=None):
    """One cell at the full registry config (``cfg`` replaces it, e.g. a
    smoke config in tests; ``mesh_shape`` a (data, model) or (pod, data,
    model) mesh in place of the production one). ``donate`` is the JAX
    flag: the port's steps update their state and cache in place
    always. ``analysis`` is recorded: the trace counts every layer."""
    del donate
    spec = registry.ARCHS[arch]
    cfg = cfg or spec.config
    shape = ALL_SHAPES[shape_name]
    skip = registry.shape_applicable(arch, shape)
    if skip:
        return {"arch": arch, "shape": shape_name,
                "multi_pod": multi_pod, "skipped": skip}
    sizes = mesh_shape or ((2, 16, 16) if multi_pod else (16, 16))
    with fake_group(math.prod(sizes)):
        mesh = _mesh(sizes)
        _check_counter(mesh)
        got = _trace(cfg, shape, mesh, spec.train_microbatches, fsdp)
    return {
        "arch": arch,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "analysis": analysis,
        "mesh": dict(mesh.shape),
        "kind": shape.kind,
        "lower_s": round(got["lower_s"], 2),
        "flops": float(got["flops"]),
        "bytes_accessed": float(got["bytes"]),
        "collectives": got["coll"],
        "params": cfg.num_params(),
        "active_params": cfg.active_params(),
        "argument_size_in_bytes": got["argument_size_in_bytes"],
        "output_size_in_bytes": got["output_size_in_bytes"],
        "spec_argument_bytes": got["spec_argument_bytes"],
    }


def _mesh(sizes):
    from repro_torch.launch.mesh import Mesh

    if tuple(sizes) in ((16, 16), (2, 16, 16)):
        return make_production_mesh(multi_pod=len(sizes) == 3)
    return Mesh(sizes, ("pod", "data", "model")[-len(sizes):], "cpu")


def analyze_cell(arch: str, shape_name: str, fsdp: bool = True,
                 microbatches: int = 1, cfg=None, mesh_shape=None):
    """Roofline counts by depth extrapolation, as the JAX analysis: trace
    the model at 1 and 2 blocks and extend linearly to the full depth,
    total = f1 + max(f2 - f1, 0) * (NB - 1); single-pod, ``microbatches``
    1. The full depth is traced too (``full_depth``) and
    ``extrapolation_exact`` says whether the two agree in every count."""
    spec = registry.ARCHS[arch]
    cfg_full = cfg or spec.config
    shape = ALL_SHAPES[shape_name]
    skip = registry.shape_applicable(arch, shape)
    if skip:
        return {"arch": arch, "shape": shape_name, "analysis": True,
                "multi_pod": False, "skipped": skip}
    sizes = mesh_shape or (16, 16)
    pat = len(cfg_full.block_pattern())
    nb_full = cfg_full.n_blocks
    sub = {}
    with fake_group(math.prod(sizes)):
        mesh = _mesh(sizes)
        _check_counter(mesh)
        for nb in (1, 2, nb_full):
            c = dataclasses.replace(cfg_full, n_layers=pat * nb)
            got = _trace(c, shape, mesh, microbatches, fsdp)
            sub[nb] = {"flops": got["flops"], "bytes": got["bytes"],
                       "coll": got["coll"], "lower_s": got["lower_s"]}

    def extrap(v1, v2):
        return v1 + max(v2 - v1, 0) * (nb_full - 1)

    coll = {}
    for k in set(sub[1]["coll"]) | set(sub[2]["coll"]):
        c1 = sub[1]["coll"].get(k, {"count": 0, "bytes": 0})
        c2 = sub[2]["coll"].get(k, {"count": 0, "bytes": 0})
        coll[k] = {"count": int(extrap(c1["count"], c2["count"])),
                   "bytes": int(extrap(c1["bytes"], c2["bytes"]))}
    flops = extrap(sub[1]["flops"], sub[2]["flops"])
    nbytes = extrap(sub[1]["bytes"], sub[2]["bytes"])
    full = sub[nb_full]
    return {
        "arch": arch,
        "shape": shape_name,
        "analysis": True,
        "multi_pod": False,
        "mesh": dict(mesh.shape),
        "kind": shape.kind,
        "flops": float(flops),
        "bytes_accessed": float(nbytes),
        "collectives": coll,
        "params": cfg_full.num_params(),
        "active_params": cfg_full.active_params(),
        "depth_points": {str(k): v for k, v in sub.items() if k in (1, 2)},
        "full_depth": full,
        "extrapolation_exact": (flops == full["flops"]
                                and nbytes == full["bytes"]
                                and coll == full["coll"]),
        "extrapolation_minus_full": {
            "flops": flops - full["flops"], "bytes": nbytes - full["bytes"],
            "collectives": {k: {f: coll.get(k, {}).get(f, 0)
                                - full["coll"].get(k, {}).get(f, 0)
                                for f in ("count", "bytes")}
                            for k in set(coll) | set(full["coll"])}},
    }


def _out_dir(path: str) -> str:
    real = os.path.realpath(path)
    if real.rstrip(os.sep).endswith(os.path.join("results", "dryrun")):
        raise SystemExit(f"--out {path}: results/dryrun holds the JAX "
                         f"package's cells; write under {DEFAULT_OUT}")
    os.makedirs(path, exist_ok=True)
    return path


def _summary(res: dict) -> str:
    gib = 2 ** 30
    colls = {k: v["count"] for k, v in res["collectives"].items()}
    line = (f"  -> ok: traced {res.get('lower_s', '-')}s, flops/device "
            f"{res['flops']:.3e}, collectives {colls}")
    if "argument_size_in_bytes" in res:
        line += (f", argument bytes/device "
                 f"{res['argument_size_in_bytes'] / gib:.3f} GiB (specs "
                 f"{res['spec_argument_bytes'] / gib:.3f} GiB)")
    if "extrapolation_exact" in res:
        line += f", extrapolation exact: {res['extrapolation_exact']}"
    return line


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--analysis", action="store_true",
                    help="1/2-block depth extrapolation (and the full "
                         "depth beside it)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="sequence-parallel residual stream")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    out = _out_dir(args.out)
    if args.seq_parallel:
        dctx.DEFAULT_SEQ_PARALLEL = True
    if args.all:
        meshes = ([False] if args.analysis
                  else ([False, True] if args.both_meshes
                        else [args.multi_pod]))
        cells = [(a, shape.name, mp)
                 for a, shape, _ in registry.cells()
                 for mp in meshes]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        cells = [(args.arch, args.shape, mp) for mp in meshes]

    failures = 0
    for arch, shape, mp in cells:
        tag = f"{arch}__{shape}__{'pod2' if mp else 'pod1'}"
        if args.analysis:
            tag += "__analysis"
        path = os.path.join(out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"[cached] {tag}")
            continue
        print(f"[trace] {tag} ...", flush=True)
        try:
            if args.analysis:
                res = analyze_cell(arch, shape, fsdp=not args.no_fsdp)
            else:
                res = lower_cell(arch, shape, mp, fsdp=not args.no_fsdp)
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
            if "skipped" in res:
                print(f"  -> SKIP: {res['skipped']}")
            else:
                print(_summary(res), flush=True)
        except Exception as e:
            failures += 1
            print(f"  -> FAIL: {e}")
            traceback.print_exc()
    if failures:
        raise SystemExit(f"{failures} cells failed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
