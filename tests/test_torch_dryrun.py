"""The port's dry-run (``repro_torch.launch.dryrun``): cells traced on
``meta`` tensors over a fake process group in this process (every call
makes its group and destroys it, so no group outlives a test).

At smoke configs on (2, 2) and (1, 4) fake meshes: every field of the
cell JSON is there, the per-device argument bytes (local shards) equal
the count from the spec trees, a (1, 1) mesh moves nothing, the serving
MoE sums over "model" with one all-reduce a layer, and the 1/2-block
extrapolation equals the full-depth trace. Skipped cells carry
``registry.shape_applicable``'s reason; a full-config decode cell on the
(16, 16) production mesh traces in seconds; the CLI writes the JAX
layout's file and refuses ``results/dryrun``. Counts are integers:
compared exactly.
"""
import dataclasses
import json
import time

import pytest
import torch

from repro_torch.configs import registry as R
from repro_torch.configs.shapes import ALL_SHAPES
from repro_torch.launch import dryrun as D

FIELDS = {"arch", "shape", "multi_pod", "analysis", "mesh", "kind",
          "lower_s", "flops", "bytes_accessed", "collectives", "params",
          "active_params", "argument_size_in_bytes", "output_size_in_bytes",
          "spec_argument_bytes"}
CELLS = [("qwen2-moe-a2.7b", "train_4k"), ("qwen2-moe-a2.7b", "prefill_32k"),
         ("qwen2-moe-a2.7b", "decode_32k"), ("jamba-1.5-large-398b",
                                             "decode_32k"),
         ("chatglm3-6b", "train_4k")]


@pytest.mark.parametrize("mesh", [(2, 2), (1, 4)])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cells_on_fake_meshes(arch, shape, mesh):
    cfg = R.ARCHS[arch].smoke
    res = D.lower_cell(arch, shape, False, cfg=cfg, mesh_shape=mesh)
    assert set(res) == FIELDS
    assert res["mesh"] == {"data": mesh[0], "model": mesh[1]}
    assert res["kind"] == ALL_SHAPES[shape].kind
    assert res["params"] == cfg.num_params()
    assert res["argument_size_in_bytes"] == res["spec_argument_bytes"] > 0
    assert res["flops"] > 0 and res["bytes_accessed"] > 0
    assert res["collectives"], "a sharded step moves data between ranks"
    for ent in res["collectives"].values():
        assert ent["count"] > 0 and ent["bytes"] > 0


@pytest.mark.parametrize("arch,shape", [("qwen2-moe-a2.7b", "train_4k"),
                                        ("qwen2-moe-a2.7b", "decode_32k"),
                                        ("jamba-1.5-large-398b",
                                         "prefill_32k")])
def test_one_device_moves_nothing(arch, shape):
    """On a (1, 1) mesh no collective runs, and the per-device counts are
    the whole program's: a (1, 2) mesh halves no more than the flops."""
    cfg = R.ARCHS[arch].smoke
    one = D.lower_cell(arch, shape, False, cfg=cfg, mesh_shape=(1, 1))
    assert one["collectives"] == {}
    assert one["argument_size_in_bytes"] == one["spec_argument_bytes"]
    two = D.lower_cell(arch, shape, False, cfg=cfg, mesh_shape=(1, 2))
    assert one["flops"] / 2 <= two["flops"] <= one["flops"]


@pytest.mark.parametrize("experts", [8, 6])
def test_serving_moe_sums_with_one_all_reduce(experts):
    """``make_spmd_moe`` on serving-placed weights (``param_pspecs(fsdp=
    False)``, EP with 8 experts and expert-TP with 6 over model=4; tokens
    split over data=2): exactly one collective, an all-reduce of the
    replies to the rank's (token, choice) pairs and the shared expert's
    partial sums, (B/2 * S, (k + 1) * d) float32."""
    from repro_torch.distributed import context
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.moe_spmd import make_spmd_moe
    from repro_torch.launch.mesh import Mesh, fake_group
    from repro_torch.models import params as Pm

    cfg = dataclasses.replace(R.ARCHS["qwen2-moe-a2.7b"].smoke,
                              moe_experts=experts)
    b, s, d = 4, 16, cfg.d_model
    with fake_group(8):
        mesh = Mesh((2, 4), ("data", "model"), "cpu")
        specs = sh.param_pspecs(cfg, mesh, fsdp=False)
        params = sh.distribute(Pm.param_specs(cfg), mesh, specs)
        lp = {k: v[0] for k, v in params["blocks"]["l0"].items()}
        x = sh.place(torch.empty(b, s, d, device="meta"),
                     sh.NamedSharding(mesh, sh.Spec("data")))
        counter = D.LocalOpCounter()
        with context.activation_sharding(mesh), counter.counting():
            make_spmd_moe(cfg, mesh)(cfg, lp, x)
    k = cfg.moe_top_k
    assert counter.collectives == {
        "all-reduce": {"count": 1, "bytes": b // 2 * s * (k + 1) * d * 4}}


@pytest.mark.parametrize("arch,shape", [("qwen2-moe-a2.7b", "prefill_32k"),
                                        ("jamba-1.5-large-398b",
                                         "train_4k")])
def test_depth_extrapolation_equals_the_full_trace(arch, shape):
    """The 1/2-block extrapolation to 3 blocks equals the 3-block trace in
    flops and every collective (the blocks are one Python loop); the
    unfused bytes within 1e-9 (the jamba step's differ by 64 bytes in 4e12,
    and the cell says so: ``extrapolation_exact`` false and the miss)."""
    cfg = R.ARCHS[arch].smoke
    cfg = dataclasses.replace(cfg, n_layers=3 * len(cfg.block_pattern()))
    res = D.analyze_cell(arch, shape, cfg=cfg, mesh_shape=(2, 2))
    assert set(res["depth_points"]) == {"1", "2"}
    one, two = res["depth_points"]["1"], res["depth_points"]["2"]
    assert two["flops"] > one["flops"]
    assert res["flops"] == res["full_depth"]["flops"]
    assert res["collectives"] == res["full_depth"]["coll"]
    miss = res["extrapolation_minus_full"]
    assert miss["flops"] == 0 and not any(
        v["count"] or v["bytes"] for v in miss["collectives"].values())
    assert abs(miss["bytes"]) <= 1e-9 * res["full_depth"]["bytes"]
    assert res["extrapolation_exact"] == (miss["bytes"] == 0)


def test_skipped_cells_carry_the_registry_reason():
    for arch, shape, reason in R.cells(include_skipped=True):
        if reason is None:
            continue
        for multi_pod in (False, True):
            res = D.lower_cell(arch, shape.name, multi_pod)
            assert res == {"arch": arch, "shape": shape.name,
                           "multi_pod": multi_pod, "skipped": reason}
        assert D.analyze_cell(arch, shape.name)["skipped"] == reason


def test_a_full_config_decode_cell_traces_in_seconds():
    """qwen2-moe-a2.7b decode_32k at the full config on the (16, 16)
    production mesh (256 fake ranks): argument bytes from the local shards
    equal the specs' count, the logits' vocabulary stays split (one
    all-gather, the sampler's (value, index) pairs)."""
    t0 = time.perf_counter()
    res = D.lower_cell("qwen2-moe-a2.7b", "decode_32k", False)
    assert time.perf_counter() - t0 < 60
    assert res["mesh"] == {"data": 16, "model": 16}
    assert res["argument_size_in_bytes"] == res["spec_argument_bytes"]
    assert res["collectives"]["all-gather"]["count"] == 1


def test_cli_writes_the_cell_and_refuses_the_jax_results(tmp_path, capsys):
    out = tmp_path / "cells"
    assert D.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                   "--out", str(out)]) == 0
    cell = json.loads((out / "mamba2-130m__long_500k__pod1.json")
                      .read_text())
    assert set(cell) == FIELDS and cell["kind"] == "decode"
    assert "-> ok" in capsys.readouterr().out
    assert D.main(["--arch", "mamba2-130m", "--shape", "long_500k",
                   "--out", str(out)]) == 0
    assert "[cached]" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="results/dryrun"):
        D.main(["--all", "--out", str(tmp_path / "results" / "dryrun")])
