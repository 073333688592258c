#!/usr/bin/env python3
"""Device times of the bucket-route kernels, split by the device kernels
each call runs, optionally against another version of the same source.

    python3 scripts/bucket_route_ab.py [--other DIR] [--rounds N]

Needs CUDA. Builds ``src/repro_torch/kernels/csrc/bucket_route.cu`` (the
checkout's version, "B") and, with ``--other``, the ``bucket_route.cu`` and
``bucket_route.py`` in DIR (another version of the kernel and its wrapper,
"A"), and runs both through their wrappers as A B B A. The inputs are the
shapes of ``chip_smoke.py`` phase 5 at R-MAT scale 20, W = 8:

  - ``bucket_ranks``: wcc:basic's first-superstep route keys (8, 2^21),
    ascending (the main path's order), and uniform random keys in
    [0, W] of the same shape;
  - ``bucket_ranks_lanes``: the batched plane's union route keys
    (8, 2^20) with Q = 32 membership lanes, half of the lanes members of
    each real entry and none of a sentinel entry, sorted and random; and
    the sorted case once more with the membership rows lying apart as the
    union CombinedMessage leaves them (a wrapper that needs dense rows
    copies them first).

For every version, case and round: the mean device time of one wrapper
call back to back (``cuda_ms``) and after an L2 flush (``cuda_ms_cold``),
exactness against the plain version, and from ``torch.profiler`` over 10
calls the device kernels (memsets and fills included) a call runs, with
their device time per call. Last, the time of one PyTorch copy of the
(8, 2^21) keys, the card's rate for ``bucket_ranks``' 8 bytes a key.
The details go to ``chiprun_out/bucket_route_ab.json``; one line per
measurement is printed.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

W, SCALE, NQ = 8, 20, 32


def load_other(path: Path):
    """The wrapper module in ``path`` bound to a library built from the
    ``bucket_route.cu`` beside it (its own ``build.library`` is replaced)."""
    from repro_torch.kernels import build

    so = ROOT / "build" / "ab" / "bucket_route_other.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
         str(path / "bucket_route.cu")], capture_output=True, text=True)
    if out.returncode:
        raise RuntimeError(f"nvcc failed for the other version:\n{out.stdout}"
                           f"{out.stderr}")
    lib = ctypes.CDLL(str(so))
    spec = importlib.util.spec_from_file_location(
        "bucket_route_other", path / "bucket_route.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build = types.SimpleNamespace(library=lambda name: lib)
    return mod, out.stdout + out.stderr


def make_inputs(dev):
    """(name, kernel, args) of the four timed cases."""
    import torch

    from repro_torch.algorithms import REGISTRY
    from repro_torch.core import routing
    from repro_torch.graph import pgraph

    g = torch.Generator(device=dev).manual_seed(0)
    cases = []
    spec = REGISTRY["wcc:basic"]
    pg = pgraph.partition_graph(spec.make_graph(SCALE, 0), W, "random",
                                build=spec.build, device=dev)
    raw, n_total = pg.raw_out, W * pg.n_loc
    u_dst, _ = routing.dedup_dense(raw.dst_global, raw.mask, n_total)
    keys = torch.where(u_dst != routing.BIG, u_dst // pg.n_loc,
                       W).to(torch.int32)
    cases.append(("bucket_ranks sorted", "plain", (keys,)))
    cases.append(("bucket_ranks random", "plain", (torch.randint(
        0, W + 1, keys.shape, device=dev, dtype=torch.int32, generator=g),)))
    spec = REGISTRY["pagerank:scatter"]
    pg = pgraph.partition_graph(spec.make_graph(SCALE, 0), W, "random",
                                build=spec.build, device=dev)
    raw, n_total = pg.raw_out, W * pg.n_loc
    u_dst, _ = routing.dedup_dense(raw.dst_global, raw.mask, n_total,
                                   min(NQ * raw.e_cap, n_total))
    lkeys = torch.where(u_dst != routing.BIG, u_dst // pg.n_loc,
                        W).to(torch.int32)
    rkeys = torch.randint(0, W + 1, lkeys.shape, device=dev,
                          dtype=torch.int32, generator=g)
    for what, k in (("sorted", lkeys), ("random", rkeys)):
        lanes = ((torch.rand(k.shape + (NQ,), device=dev, generator=g) < 0.5)
                 & (k < W)[..., None])
        cases.append((f"bucket_ranks_lanes {what}", "lanes", (k, lanes)))
    # the union CombinedMessage's own layout: rows of a (W, M * Q + 16)
    # buffer (core/message.py), read in place or copied by the wrapper
    rows, m = lkeys.shape
    buf = torch.zeros((rows, m * NQ + 16), dtype=torch.bool, device=dev)
    buf[:, :m * NQ] = cases[-2][2][1].reshape(rows, m * NQ)
    cases.append(("bucket_ranks_lanes sorted, main-path layout", "lanes",
                  (lkeys, buf[:, :m * NQ].reshape(rows, m, NQ))))
    return cases


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, default=None,
                    help="directory with another bucket_route.cu and "
                    "bucket_route.py (version A)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="A B rounds; the order runs A B B A ...")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bucket_route_ab: CUDA is not available", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch.kernels import bucket_route, build
    from repro_torch.kernels import ref as kref

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    logs = build.build_all(("bucket_route",))
    versions = {"B": (bucket_route, logs.get("bucket_route", ""))}
    if args.other is not None:
        versions["A"] = load_other(args.other)
    ptxas = {v: [ln.strip() for ln in log.splitlines() if "registers" in ln
                 or "Compiling" in ln] for v, (_, log) in versions.items()}
    order = []
    for r in range(args.rounds):
        pair = ["A", "B"] if "A" in versions else ["B"]
        order += pair if r % 2 == 0 else pair[::-1]
    cases = make_inputs(dev)
    plain = {name: (kref.bucket_ranks_ref(*a, W) if kind == "plain"
                    else kref.bucket_ranks_lanes_ref(*a, W))
             for name, kind, a in cases}
    print(f"bucket_route_ab: {smi} | order {' '.join(order)}", flush=True)
    results = []
    for rnd, v in enumerate(order):
        mod = versions[v][0]
        for name, kind, a in cases:
            fn = ((lambda a=a: mod.bucket_ranks_cuda(*a, W)) if kind == "plain"
                  else (lambda a=a: mod.bucket_ranks_lanes_cuda(*a, W)))
            got = fn()
            exact = all(torch.equal(x, y) for x, y in zip(got, plain[name]))
            row = dict(round=rnd, version=v, case=name, exact=exact,
                       shape=list(a[-1].shape), cuda_ms=cs.cuda_ms(fn),
                       cuda_ms_cold=cs.cuda_ms_cold(fn),
                       kernels=cs.kernels_per_call(fn))
            results.append(row)
            split = "; ".join(f"{k[:48]} {n:g}x {ms:.4f}"
                              for k, (n, ms) in row["kernels"].items())
            print(f"{rnd} {v} {name} {row['shape']}: exact {exact}, "
                  f"{row['cuda_ms']:.4f} ms warm, {row['cuda_ms_cold']:.4f} "
                  f"ms L2 flushed | {split}", flush=True)
    # the card's rate for the same bytes: one PyTorch copy of the keys into
    # a rank-sized tensor reads 4 and writes 4 bytes a key, as the kernel
    keys = cases[0][2][0]
    copy_out = torch.empty_like(keys)
    copy_ms = cs.cuda_ms(lambda: copy_out.copy_(keys))
    print(f"yardstick: copy of the {list(keys.shape)} keys {copy_ms:.4f} ms "
          f"warm ({2 * keys.numel() * 4 / copy_ms / 1e9:.3f} TB/s)")
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "bucket_route_ab.json").write_text(json.dumps(dict(
        nvidia_smi=smi, device=torch.cuda.get_device_name(0), order=order,
        ptxas=ptxas, results=results, key_copy_ms=copy_ms), indent=1))
    print(smi)
    return 0 if all(r["exact"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
