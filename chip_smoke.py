#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main paths on the card: R-MAT generator →
partitioner → plans → channels → host-driven superstep loop →
``Engine.run`` → oracle check for ``wcc:basic``, ``pagerank:scatter``,
the composed S-V program ``sv:composed`` (RequestRespond, ScatterCombine,
CombinedMessage and full pointer jumping under one ``compose.Stacked``),
the rest of the paper's table (``pagerank:basic``, whose float32 sums go
through the stable sort and the kernel, and Boruvka ``msf:channels``/
``monolithic``, whose candidate combine is the kernel's ``min_by_first``)
with the port's paper table (``repro_torch.paper_tables``), the
batched query plane — ``Engine.run_batch`` of Q=32 sources of
``reach:basic`` and ``sssp:basic`` through the union CombinedMessage —
checked against solo runs and the host oracles, and the Propagation
channel (``wcc:prop``, ``sssp:prop``, ``scc:basic``/``prop``: a local
fixpoint between cut exchanges, every combine a ``segment_combine``
launch on ids sorted at plan build), and the device modes (``fused``,
``chunked``: K supersteps captured into one CUDA graph, each under an IF
node, replayed once a dispatch) for all 21 programs, the inner loops of
seven of them (pointer jumping, label propagation, the Propagation
channel's rounds and local fixpoints) as WHILE nodes nested inside the
IF nodes; the batched plane in the device modes, and the
continuous-batching service (``Engine.serve``: a Poisson stream of
queries through always-on lanes of the chunked serving substrate,
harvested and refilled between replays); ``pagerank:personal`` (the
static channels under the batched plane: the Q lanes as the columns of
each ``segment_combine`` launch) and batched ``pj:reqresp`` (the union
RequestRespond) solo, batched and served, and the ``route_batch="lane"``
baseline against the union route; batched ``sssp:prop`` (the Propagation
channel under the batched plane, each lane its own fixpoint) solo,
batched and served, checkpoint/resume on the chunked CUDA-graph loop,
overflow escalation (``Engine(on_overflow="escalate")``) and ``python -m
repro_torch bench-batch``; and the channel planner (``Engine(plan=
"auto")``, its calibration probes on the card, a hand-set twin with the
plan's knobs, the ``dense_threshold`` knob and ``python -m repro_torch
plan --explain``). Phases, one or more lines each:

  1. environment and kernel build; then, on a card that holds nothing
     else yet, the LM serving path (:func:`lm_phase`, lines ``[lm]``,
     ``chiprun_out/lm_serve.json``): all ten registry smoke configs in
     float32 (weights drawn on the CPU and moved to the card; the card's
     forward within 1e-3 of the CPU's, prefill plus four decode steps
     within 2e-3 of the full forward, greedy ``generate`` twice
     bit-identical); ``qwen2-moe-a2.7b`` at full width, depth 2, float32
     (the prefill's last logits equal the full forward's bit for bit at
     capacity factor 1.25; at E/k, no drops, 8 decode steps within 2e-3
     of the full forward); ``qwen2-moe-a2.7b`` at full width and depth in
     bfloat16, weights drawn on the card, serving 4 requests of 512 prompt
     tokens and 32 new tokens greedy twice (bit-identical) and sampled at
     0.8 twice from one seed (identical), the prefill bit for bit against
     the full forward, every logit finite, the pairs its MoE layers
     dropped, prefill ms and decode ms a token at batch 1, 8 and 32 beside
     their bounds, peak memory and init seconds; ``mamba2-130m`` at full
     width in float32 (a 300-token prompt, 8 decode steps within 2e-3 of
     the full forward). The LM path launches none of the three kernels
     (wrapper and device counts checked). Then LM training
     (:func:`train_phase`, lines ``[train]``, ``chiprun_out/train.json``):
     the ten smoke configs in float32 (loss and gradients on the card
     against the CPU's, one step twice bit-identical, microbatches 2
     against 1); ``internvl2-2b`` at full width and depth (float32 master
     weights and AdamW, bf16 compute, remat, microbatches 2, 8 x (256 +
     768) positions, 8 steps: step 0 twice from one seed with equal
     checksums, losses finite, ms a step, positions/s and tokens/s, the
     FLOP bound, peak
     memory); ``qwen2-moe-a2.7b`` at full width, depth 2, float32, one
     step twice bit-identical; ``mamba2-130m`` at full width through
     ``launch.train.main``: 12 steps, then a resume to 20 equal to a
     straight 20-step run bit for bit (save and restore ms); ``python -m
     repro_torch.train_lm --steps 10`` beside the smoke configs' checks,
     before the timed parts. No graph kernel launches;
  2. each kernel against its plain PyTorch version on the card, the two
     bucket kernels at the main path's full shapes on random, sorted,
     one-bucket, all-sentinel and out-of-range keys, and
     ``segment_combine`` as the S-V neighbour minimum's int32 ``min`` at
     the scale-20 S-V plan (sender and receiver side: vertex ids,
     INT32_MAX/INT32_MIN, one hub segment, every id dropped);
     ``min_by_first`` bit-exact on the first superstep's msf candidate
     combine (D = 1, 3, 4, 5, int32, a hub of tied keys, NaN/+-inf/-0.0
     keys, all dropped), ``prod``, and the order-sensitive dispatch twice
     bit-identical on pagerank:basic's float32 sums; the Propagation
     channel's ``min`` at the scale-20 ``wcc:prop`` plan (``int_dst``, the
     cut plan's sender and receiver: the int32 cases above, and float32
     with +inf); each main-path kernel captured into a CUDA graph and
     replayed on fresh inputs (``bucket_ranks`` four times, the lanes
     kernel, ``segment_combine``'s int32 ``min`` and ``min_by_first``
     three times, with a run of empty segments that moves), every replay
     exact; ``bucket_ranks`` across the end of its epoch lap, eagerly and
     inside a WHILE node; before that, the WHILE node alone in one
     captured graph (inside an IF, inside a WHILE inside an IF, zero
     trips, replayed from fresh trip counts and with the IF false), every
     loop counting its iterations exactly; last (ROADMAP fault 11,
     :func:`fault11_cases`), the bucket kernels bit for bit past 63
     buckets (W = 64, 256, 1,024 with their counts in shared memory,
     4,096 in global memory), past 65,535 rows and past a 32 KB lane tile
     (Q = 1,024, 4,096 and 6,500 at W=8), ``segment_combine`` on 70,000
     rows, ``wcc:basic`` and ``sv:composed`` at W=64 (host and fused) and
     a Q=1,024 ``run_batch`` equal to the port's CPU runs, and the times
     of kernel-table rows 1b and 3b;
  3. reference traffic counts at scale 12, W=8 (exact), solo and batched
     (every batched lane bit-identical to its solo run), and the nine
     composition-layer programs (six S-V variants, ``wcc:switch``,
     ``pj:basic``/``reqresp``) with their bytes per channel, the S-V
     variants' labels identical and ``sv:composed`` ahead of ``sv:basic``
     on supersteps and bytes; ``pagerank:basic`` and both MSF variants
     with their bytes per channel, and the port's paper table row for
     row against the reference's counts, headline held; the four
     Propagation programs with their bytes per channel and per-worker
     rounds and local iterations (``PROP_REFS``), and scipy's strong
     components against ``oracles.scc_oracle``; ``pagerank:personal``
     from source 0 (``PERSONAL_REFS``) and the Q=32 batches of all five
     batched programs (``BATCH_REFS``; batched ``sssp:prop``'s per-lane
     rounds and local iterations too, ``BATCH_INFO_REFS``), every lane
     equal to its solo run; ``wcc:switch`` and ``sssp:basic`` under
     ``Engine(mode="host", plan="auto")`` (``PLAN_REFS``: the JAX planned
     counts, the plan on the kernels, the bucket route and the default
     threshold);
  4. the main paths at R-MAT scale 20, W=8, checked against the host
     oracles, each with its kernels' launch counts (counts reset just
     before the path and read just after): pagerank run twice
     (bit-identical); ``sv:composed`` against ``sv:basic`` (supersteps,
     bytes, ms a superstep, wall time, peak memory), ``wcc:switch`` and
     ``pj:reqresp`` beside them; ``pagerank:basic`` twice bit-identical,
     both MSF variants against Kruskal (|weight - oracle| <= 1e-2 +
     1e-5 * oracle: float32 sums near 1.4e5), the ground truth and
     n - #components edges, ``msf:channels`` below ``msf:monolithic`` in
     bytes; the port's paper table at scale 20 (host mode, headline held,
     ``chiprun_out/paper_tables_torch.json``); every lane of the batched
     runs bit-identical to its solo run, queries/s batched and solo, peak
     device memory; the same Q=32 batches in ``fused`` (the second,
     cached run) and ``chunked`` K=64 and K=4 (one run each, the capture
     included), bit-identical to the host run
     (outputs, per-query steps, halts, bytes, msgs, pad audit, state),
     ``bucket_ranks_lanes`` launching as often as the host run's wrappers
     count, as the kernel counts on the device, and a Q=20 batch (12 pad
     lanes) replaying the fused loop and equal to the full run's lanes:
     wall, loop wall, queries/s, dispatches, host overhead a superstep,
     capture time and peak memory of each; ``Engine.serve`` of the same 32
     sources as a Poisson stream (one a superstep) through 8 lanes at
     serve chunks 4 and 64, two sessions each (the second a replay), every
     served query equal to its solo run, ``bucket_ranks_lanes`` launching
     once a superstep run (q/s, p50/p99 latency in supersteps and ms,
     median dispatch), and a quarantined query isolated from the rest;
     ``wcc:prop`` on the ``wcc:basic`` partition (ground
     truth; fewer global rounds and bytes than ``wcc:basic``),
     ``sssp:prop`` (oracle; ``sssp:basic``'s distances bit for bit),
     ``scc:basic``/``prop`` (scipy's strong components; ``scc:prop`` below
     ``scc:basic`` in bytes), each with its launches (``segment_combine``
     in all four, ``bucket_ranks`` in ``scc:basic``); all 21 programs
     (the seven with inner loops among them, whose kernels then launch
     many times inside one graph launch) on those partitions in host
     mode and in ``fused`` (the second, cached run) and ``chunked`` K=64
     and K=4 (one run each), each bit-identical to host mode and
     launching each kernel as often, as the kernels count their launches
     on the device (chunked: as the runtime counts its replays; the
     device's count adds the warm-up step): wall
     time, capture time, dispatches, host overhead a superstep and peak
     memory of each; ``pagerank:personal`` from source 0 in host, fused,
     chunked K=64 and K=4 (bit-identical, oracle), then for it and for
     batched ``pj:reqresp`` (Q=32 forests on the scale-20 forest) 32
     queries solo (fused for pagerank, host for pj), ``run_batch`` in
     every mode (every lane equal to its solo run, launches equal on the
     device, a Q=20 batch with 12 pad lanes) and served at chunks 4 and
     64: queries/s batched against solo, ms a superstep, peak memory; and
     ``reach:basic``, ``sssp:basic`` and ``pj:reqresp`` at Q=32 fused
     under ``route_batch="lane"`` against the union route (lanes equal,
     run walls and their ratio); batched ``sssp:prop`` the same way (32
     sources solo fused, batched in every mode, served; every lane's
     distances, ``info`` rows, bytes and msgs equal to its solo run, two
     lanes against the oracle); ``wcc:basic`` and ``sv:composed``
     chunked at K=2 with a checkpoint every two supersteps, resumed from
     every checkpoint on the cached graph (no new capture), each resume
     bit-identical to the uninterrupted run (checkpoint size, save and
     load ms, resumed walls); ``sv:composed``, ``pagerank:basic``,
     ``msf:channels`` and a Q=32 ``run_batch`` of ``reach:basic`` fused
     from ``cap_scales={"*": 0.125}`` under ``on_overflow="escalate"``:
     a trail naming channels (and lanes), the recovered run equal to the
     plain run, the second run a cache hit without recovery (attempts,
     each capture's seconds, peak memory); and ``python -m repro_torch
     bench-batch --queries 32 --scale 20`` on ``BENCH_BATCH_KEYS`` as a
     subprocess that must exit 0 (``chiprun_out/bench_batch.json``); the
     multi-device phase
     (:func:`dist_phase`): ``python -m repro_torch.launch.jobs`` as a
     subprocess, W=4 ranks of one gloo group sharing the card
     (``Engine(backend="dist")``, host mode; NCCL, one card a rank, too
     when there are 4 cards) at scale 20 — ``wcc:basic``,
     ``sv:composed``, ``sssp:basic``, ``pagerank:scatter``; ``wcc:switch``,
     ``sv:composed``, ``sssp:basic`` on the ``degree`` partition mirrored
     at 8 and unmirrored; Q=8 batches of ``sssp:basic`` and
     ``pj:reqresp`` — each held bit for bit to one process's host run at
     W=4 on the card (state, outputs, supersteps, halts, bytes and msgs
     per channel and per lane, and each kernel's launches on every rank),
     with the oracles; transport, walls and ms a superstep on both
     backends, collectives, peak memory per rank
     (``chiprun_out/dist_gloo.log``); the planner: every program
     planned on its scale-20 partition (the five batched ones also at
     Q=32) with a probe cache in a temporary directory, each plan on the
     kernels and the bucket route, a second planner on the warm cache
     giving the same plans, the probe times on the card (bucket kernel
     against the sort baseline, combine kernel against its plain
     version; every table in ``chiprun_out/plans_explain.txt``);
     ``Engine(plan="auto")`` against an Engine given the plan's knobs
     for ``wcc:switch``, ``sssp:basic`` and ``pagerank:scatter`` fused,
     chunked K=4 and host, and batched ``reach:basic`` Q=32 fused: planning
     leaves ``stats()`` alone, the second run a cache hit on one key,
     bit-identical, the same launches on the device; ``wcc:switch`` fused
     at its planned threshold against 0.1 (supersteps, bytes a branch,
     run wall; both the ground truth); and ``python -m repro_torch plan
     --scale 20 --explain`` as a subprocess
     (``chiprun_out/plan_explain_cli.txt``);
  5. each kernel's time against its plain version, its bound and a
     PyTorch yardstick at the scale-20 shapes (the bucket kernels also on
     random keys, warm and L2-flushed, and checked to run one device
     kernel a call, fills and memsets counted; ``segment_combine``
     checked to run two, and also
     as int32 ``min`` at the S-V plan, as ``min_by_first`` at the msf plan
     and as the float32 sum of pagerank:basic's CombinedMessage, each also
     with its stable sort, and as the int32 ``min`` at ``wcc:prop``'s
     ``int_dst``; rows 2e and 3a: ``segment_combine`` on
     ``pagerank:personal``'s Q·D columns, send and receive, each column
     bit-exact against its D=1 call, and ``bucket_ranks_lanes`` at the
     ``_request_union`` shape, both as the first batched superstep hands
     them over; row 2f: its float32 ``min`` on batched ``sssp:prop``'s 32
     columns at the three Propagation sites, each column bit-exact
     against its D=1 call, ``scatter_reduce_`` amin the yardstick), and
     one run of each program (the batched sssp,
     ``sv:composed``, ``pagerank:basic``, ``msf:channels``, the four
     Propagation programs and the fused ``pagerank:scatter``,
     ``wcc:basic`` and ``wcc:prop`` among them) under torch.profiler
     (device busy share, top kernels and aten ops;
     ``chiprun_out/profile_*.txt``); then the served LM's prefill and
     its decode steps at batch 1 and 32 under torch.profiler
     (:func:`lm_traced`: device time and device kernels a step against
     the untraced ms, ``chiprun_out/profile_lm_*.txt``), and one
     ``internvl2-2b`` train step (:func:`train_traced`, its busy share).

Then the kernel table as one JSON line, the card's name and power limit,
and as the last line ``{"ok": true, "device": {...}}``. Any failed check
raises: the script exits non-zero and prints no result. Details go to
``chiprun_out/chip_smoke.json``. It needs CUDA and the repository's
``src/`` beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
W = 8
FULL_SCALE = 20
NQ = 32  # queries per batched run
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
INT32_MAX, INT32_MIN = 2**31 - 1, -2**31
# the device kernel that marks one launch of each wrapper in a
# torch.profiler trace (a segment_combine call runs tile_kernel, then
# join_kernel; a bucket call runs ranks_kernel or wide_ranks_kernel): the
# profiled runs hold the trace's counts beside the kernels' own
LAUNCH_EVENTS = {"bucket_ranks": "ranks_kernel<false>(",
                 "bucket_ranks_lanes": "ranks_kernel<true>(",
                 "segment_combine": "::tile_kernel<"}
# (label, mode, K, runs) of the device-mode runs in phase 4: fused runs
# twice (the second replays the cached loop and is reported, the replay
# check); chunked K=64 and K=4 run once, the capture inside the wall,
# which keeps the script inside its time limit with the LM phases
MODE_RUNS = {"fused": ("fused", 64, 2), "chunked64": ("chunked", 64, 1),
             "chunked4": ("chunked", 4, 1)}
# the programs whose fused run phase 5 profiles
PROFILED_FUSED = ("pagerank:scatter", "wcc:basic", "wcc:prop")
# the serving sessions of phase 4: lanes, and the serve chunks (4 forces
# refills between a query's supersteps; 64 admits only when a chunk ends)
SERVE_LANES = 8
SERVE_CHUNKS = (4, 64)

# (supersteps, messages, bytes, bytes by channel) of the composition
# layer's programs at scale 12, W=8, random partitioner: the S-V variants
# and wcc:switch on rmat(12, edge_factor=8, seed=2) symmetrised, pointer
# jumping on the registry's scale-12 forest (the JAX package's host-mode
# Engine gives these counts)
SV_REFS = {
    "sv:composed": (3, 39526, 159356, {
        "sv/neighbor_min": 132204, "sv/jump": 21776, "sv/merge": 2504,
        "sv/pointer/request": 1436, "sv/pointer/respond": 1436}),
    "sv:basic": (4, 78907, 631256, {
        "combined_message": 352544, "basic_reqresp/request": 138112,
        "basic_reqresp/respond": 138112, "merge_message": 2488}),
    "sv:reqresp": (4, 49005, 373536, {
        "combined_message": 352544, "request_respond/request": 9252,
        "request_respond/respond": 9252, "merge_message": 2488}),
    "sv:scatter": (4, 78907, 454984, {
        "scatter_combine": 176272, "basic_reqresp/request": 138112,
        "basic_reqresp/respond": 138112, "merge_message": 2488}),
    "sv:both": (4, 49005, 197264, {
        "scatter_combine": 176272, "request_respond/request": 9252,
        "request_respond/respond": 9252, "merge_message": 2488}),
    "sv:monolithic": (4, 222294, 1778352, {
        "mono_message": 1502128, "basic_reqresp/request": 138112,
        "basic_reqresp/respond": 138112}),
    "wcc:switch": (6, 55092, 220396, {
        "wcc/dense/scatter_combine": 220340,
        "wcc/sparse/combined_message": 56}),
    "pj:basic": (6, 42990, 343920, {
        "basic_reqresp/request": 171960, "basic_reqresp/respond": 171960}),
    "pj:reqresp": (6, 14346, 57384, {
        "request_respond/request": 28692, "request_respond/respond": 28692}),
}

# the rest of the paper's table at scale 12, W=8: pagerank:basic (10
# iterations) on rmat(12, edge_factor=12, seed=1) directed; both MSF
# variants on rmat(10, edge_factor=8, seed=4, weighted) symmetrised (the
# paper table's MSF instance at --scale 12), forest 160.16527 with 798
# edges (the JAX package's host-mode Engine gives these counts)
NEW_REFS = {
    "pagerank:basic": (10, 98130, 780560, {
        "combined_message": 776080, "aggregator": 4480}),
    "msf:channels": (4, 29197, 120644, {
        "msf/nbrcomp/request": 49264, "msf/nbrcomp/respond": 49264,
        "msf/jump": 10752, "msf/candidate": 4820,
        "msf/cycle/request": 2196, "msf/cycle/respond": 2196,
        "msf/relabel/request": 1076, "msf/relabel/respond": 1076}),
    "msf:monolithic": (4, 96711, 1934220, {
        "nbrcomp/request": 853600, "nbrcomp/respond": 853600,
        "pj_loop": 109840, "relabel/request": 40680,
        "relabel/respond": 40680, "cycle/request": 15500,
        "cycle/respond": 15500, "candidate": 4820}),
}
MSF_REF_EDGES, MSF_REF_WEIGHT = 798, 160.16527

# (program, supersteps, messages, bytes) of every row of the paper table
# at --scale 12, host mode (the JAX package's host-mode Engine on the
# benchmarks' datasets gives these counts)
PAPER_REFS = [
    ("sv:basic", 4, 78907, 631256),
    ("sv:composed", 3, 39526, 159356),
    ("wcc:basic", 6, 42027, 336216),
    ("wcc:switch", 6, 55092, 220396),
    ("pagerank:basic", 10, 98130, 780560),
    ("pagerank:scatter", 10, 98130, 392520),
    ("pj:basic", 6, 42990, 343920),
    ("pj:reqresp", 6, 14346, 57384),
    ("msf:monolithic", 4, 96711, 1934220),
    ("msf:channels", 4, 29197, 120644),
]


# the Propagation programs at scale 12, W=8, random partitioner, on the
# registry recipes (wcc on rmat(12, 4, seed=2) symmetrised, sssp on
# rmat(12, 4, seed=5, weighted) from source 0, scc on rmat(12, 3, seed=7)):
# (supersteps, messages, bytes, bytes by channel, the per-worker counter:
# wcc/sssp state["info"] = [global rounds, local iterations], scc
# state["iters"]) — the JAX package's host-mode Engine gives these counts
PROP_REFS = {
    "wcc:prop": (1, 21523, 86092, {"propagation": 86092}, [
        [6, 14], [6, 17], [6, 15], [6, 21], [6, 15], [6, 21], [6, 18],
        [6, 18]]),
    "sssp:prop": (1, 14423, 57692, {"propagation": 57692}, [
        [10, 16], [10, 20], [10, 22], [10, 17], [10, 25], [10, 22],
        [10, 21], [10, 21]]),
    "scc:prop": (2, 42037, 168148, {
        "degree/in": 37120, "degree/out": 37624, "propagation/bwd": 41820,
        "propagation/fwd": 51584}, [33, 38, 33, 53, 35, 41, 38, 43]),
    "scc:basic": (2, 57407, 384512, {
        "basic_propagation/bwd": 162760, "basic_propagation/fwd": 147008,
        "degree/in": 37120, "degree/out": 37624}, [16] * 8),
}
# (supersteps, messages, bytes) of a Q=32 run_batch at scale 12, W=8,
# random partitioner, on the registry recipes and query batches (reach and
# pagerank:personal: 32 sources of rmat(12, 4, seed=2) directed; sssp:
# rmat(12, 4, seed=5, weighted); pj:reqresp: 32 forests of 4096 vertices)
# — the JAX package's host-mode run_batch gives these counts, under either
# route_batch
BATCH_REFS = {
    "reach:basic": (7, 118509, 948072),
    "sssp:basic": (16, 333297, 2666376),
    "pagerank:personal": (30, 5441280, 21765120),
    "pj:reqresp": (6, 462150, 1848600),
    "sssp:prop": (1, 277948, 1111792),
}
# batched sssp:prop's per-lane info counters in that run: each lane's
# global rounds (equal on every worker) and its local iterations summed
# over the W workers (the JAX package's host-mode run_batch gives these)
BATCH_INFO_REFS = {
    "sssp:prop": (
        [1, 13, 12, 1, 1, 15, 1, 10, 1, 13, 12, 1, 12, 12, 12, 11, 1, 1, 1,
         1, 1, 1, 15, 1, 9, 1, 1, 14, 1, 12, 1, 14],
        [8, 216, 188, 8, 8, 249, 8, 182, 8, 234, 239, 8, 238, 223, 203, 210,
         8, 8, 8, 8, 8, 8, 230, 8, 155, 8, 8, 231, 8, 215, 8, 224]),
}
# pagerank:personal from source 0 at scale 12, W=8, the same graph
# (supersteps, messages, bytes, bytes by channel; the JAX package's
# host-mode Engine gives these counts)
PERSONAL_REFS = {
    "pagerank:personal": (30, 170040, 680160,
                          {"aggregator": 13440, "scatter_combine": 666720}),
}

# (supersteps, messages, bytes, bytes by channel) of Engine(mode="host",
# plan="auto") at scale 12, W=8, random partitioner, on the registry
# recipes (wcc:switch on rmat(12, 4, seed=2) symmetrised; sssp:basic on
# rmat(12, 4, seed=5, weighted) from source 0) — the JAX package's planned
# host-mode Engine gives these. Its CPU corpus plans dense_threshold 0.02;
# a card plan takes the default 0.1 (no card corpus), and at scale 12 both
# thresholds give these counts.
PLAN_REFS = {
    "wcc:switch": (6, 40474, 161972,
                   {"wcc/dense/scatter_combine": 161820,
                    "wcc/sparse/combined_message": 152}),
    "sssp:basic": (11, 18819, 150552, {"combined_message": 150552}),
}
# (label, mode, K) of the planner phase's planned-against-hand-set runs
PLAN_MODES = {"fused": ("fused", 64), "chunked4": ("chunked", 4),
              "host": ("host", 64)}

# the state key of each program's per-worker counter
PROP_COUNTER = {"wcc:prop": "info", "sssp:prop": "info", "scc:prop": "iters",
                "scc:basic": "iters"}


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


HOLD_CYCLES = 1_000_000  # ~0.5 ms of the card's clock per queued call


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` back-to-back launches
    (CUDA events). A spin kernel holds the card while the host queues all
    ``reps`` calls, so a call whose Python wrapper takes longer than its
    kernels is still timed on the device, not on the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES * reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_cold(fn, reps: int = 20) -> float:
    """Mean device time of one ``fn()`` after the 50 MB L2 cache was
    flushed (a 256 MB buffer written just before each launch)."""
    import torch

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def traced(fn, attempts: int = 3):
    """``fn()`` under torch.profiler (CPU and CUDA activity): its result
    and the trace's ``key_averages()``. Every traced call here launches
    device kernels, so a trace without a single device event is a
    failure of the tracer, not a measurement: it is taken again, up to
    ``attempts`` times, and then the run fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        if any(e.device_type == DeviceType.CUDA for e in events):
            return out, events
        print("chip_smoke: torch.profiler recorded no device event; "
              "tracing again", file=sys.stderr, flush=True)
    raise SmokeFailure(
        f"torch.profiler recorded no device event in {attempts} traces")


def kernels_per_call(fn, calls: int = 10) -> dict:
    """{device kernel name: [launches, device ms] per call} of ``fn()``,
    from torch.profiler over ``calls`` calls (fills and memsets count)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    _, events = traced(lambda: [fn() for _ in range(calls)])
    return {e.key[:80]: [e.count / calls,
                         e.self_device_time_total / 1e3 / calls]
            for e in events if e.device_type == DeviceType.CUDA}


def bucket_edge_cases(dev, g, lkeys) -> list:
    """``bucket_ranks`` at wcc's route-key shape (W, 2^21) and
    ``bucket_ranks_lanes`` at the batched plane's (W, M, Q), each exact
    against its plain version where a chained scan over tiles can break:
    random keys, sorted runs, one hub bucket (ranks up to M - 1 down a
    row's whole chain of tiles), every key the sentinel, keys outside
    [0, W] (rank 0, no count); for the lanes kernel also the main path's
    union keys ``lkeys``. Membership: half the lanes of each entry that is
    not a sentinel. Returns the case names."""
    import torch
    from repro_torch.kernels import ops, ref as kref

    def cases(shape):
        rnd = torch.randint(0, W + 1, shape, device=dev, dtype=torch.int32,
                            generator=g)
        bad = rnd.clone()
        pick = torch.rand(shape, device=dev, generator=g)
        bad[pick < 0.05] = -1
        bad[(pick >= 0.05) & (pick < 0.1)] = W + 3
        return {"random": rnd, "sorted": torch.sort(rnd, dim=1)[0],
                "hub": torch.full_like(rnd, 3),
                "all sentinel": torch.full_like(rnd, W), "out of range": bad}

    names = []
    for what, keys in cases((W, 1 << 21)).items():
        got, want = ops.bucket_ranks(keys, W), kref.bucket_ranks_ref(keys, W)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"bucket_ranks {what} at ({W}, 2^21) differs from plain")
        names.append(f"bucket_ranks {what}")
    for what, keys in dict(cases(tuple(lkeys.shape)), union=lkeys).items():
        lanes = ((torch.rand(keys.shape + (NQ,), device=dev, generator=g)
                  < 0.5) & (keys != W)[..., None])
        got = ops.bucket_ranks_lanes(keys, lanes, W)
        want = kref.bucket_ranks_lanes_ref(keys, lanes, W)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"bucket_ranks_lanes {what} at {tuple(lanes.shape)} differs "
              "from plain")
        names.append(f"bucket_ranks_lanes {what}")
    return names


# ROADMAP fault 11: shapes the narrow bucket kernels refused, held bit for
# bit to kernels/ref.py (W workers: B + 1 = W + 1 buckets)
WIDE_WORKERS = (64, 256, 1024)
WIDE_GLOBAL_WORKERS = 4096  # the wide kernel's counts in global memory
TALL_ROWS = 70_000  # past the 65,535 rows a grid dimension held
WIDE_E2E = ("wcc:basic", "sv:composed")  # at W=64, scale WIDE_E2E_SCALE
WIDE_E2E_SCALE = 16
WIDE_Q = 1024  # the batched run's lanes at W=8 (the limit was Q = 909)
WIDE_Q_SCALE = 10


def fault11_cases(dev, g) -> dict:
    """The case list of fault 11 (:data:`WIDE_WORKERS` and more): each
    call bit for bit against the plain version; then ``wcc:basic`` and
    ``sv:composed`` at W=64 through ``Engine.run`` in host and fused mode
    equal to the port's CPU host run (outputs, supersteps, halts, bytes
    and msgs per channel), and a Q = WIDE_Q ``run_batch`` of
    ``reach:basic`` at W=8 equal to the CPU's lane for lane. Returns the
    cases, the runs and the times of kernel-table rows 1b and 3b."""
    import math

    import numpy as np
    import torch

    from repro_torch.algorithms import REGISTRY
    from repro_torch.graph import pgraph
    from repro_torch.kernels import bucket_route as kbucket, ops, ref as kref
    from repro_torch.pregel.engine import Engine

    tile = kbucket.TILE_KEYS

    def keys_of(case, rows, m, b):
        k = torch.randint(0, b + 1, (rows, m), device=dev, dtype=torch.int32,
                          generator=g)
        if case == "sorted":
            k = torch.sort(k, dim=1)[0]
        elif case == "hub":
            k.fill_(b // 2)
        return k

    def lanes_of(keys, q, b):
        return (torch.rand(keys.shape + (q,), device=dev, generator=g)
                < 0.5) & (keys != b)[..., None]

    cases = []
    plain = [(c, 8, 3 * tile + 17, w) for w in WIDE_WORKERS
             for c in ("sorted", "random")]
    plain += [("random", 1, 40 * tile + 3, 1024), ("hub", 1, 5 * tile, 1024),
              ("sorted", 2, 5 * tile + 1, WIDE_GLOBAL_WORKERS),
              ("random", 2, 5 * tile + 1, WIDE_GLOBAL_WORKERS),
              ("random", TALL_ROWS, 1000, 8), ("sorted", TALL_ROWS, 1000, 64)]
    for case, rows, m, b in plain:
        keys = keys_of(case, rows, m, b)
        got = kbucket.bucket_ranks_cuda(keys, b)
        want = kref.bucket_ranks_ref(keys, b)
        check(all(torch.equal(a, w) for a, w in zip(got, want)),
              f"bucket_ranks {case} ({rows}, {m}) at B={b} differs from "
              f"plain")
        cases.append(f"ranks {case} ({rows}, {m}) B={b} "
                     f"{kbucket.launch_plan(b, rows, m)[:3]}")
    lane = [("sorted", 2, 2 * tile + 3, 8, 1024),
            ("random", 2, 2 * tile + 3, 8, 1024),
            ("random", 2, tile + 3, 8, 4096), ("random", 1, tile + 3, 8, 6500),
            ("sorted", 8, 3 * tile + 17, 64, 32),
            ("random", 8, 3 * tile + 17, 64, 32),
            ("random", 2, tile + 1, WIDE_GLOBAL_WORKERS, 16),
            ("random", TALL_ROWS, 100, 8, 32)]
    for case, rows, m, b, q in lane:
        keys = keys_of(case, rows, m, b)
        lanes = lanes_of(keys, q, b)
        for _ in range(2):  # the second call finds the accumulator zeroed
            got = kbucket.bucket_ranks_lanes_cuda(keys, lanes, b)
            want = kref.bucket_ranks_lanes_ref(keys, lanes, b)
            check(all(torch.equal(a, w) for a, w in zip(got, want)),
                  f"bucket_ranks_lanes {case} ({rows}, {m}, {q}) at B={b} "
                  f"differs from plain")
        cases.append(f"lanes {case} ({rows}, {m}, {q}) B={b} "
                     f"{kbucket.launch_plan(b, rows, m, q)[:3]}")
    check(not kbucket.scratch_of(dev).zero.any(),
          "the lanes kernel left its accumulator non-zero")
    seg = torch.sort(torch.randint(0, 27, (TALL_ROWS, 40), device=dev,
                                   generator=g), dim=1)[0].to(torch.int32)
    f32 = torch.rand((TALL_ROWS, 40), device=dev, generator=g)
    half = TALL_ROWS // 2

    def split(vals, name):
        """The rows as two calls of at most 65,535 rows (one block a
        row): the looping launch sums each row in the same order."""
        return torch.cat([ops.segment_combine(vals[:half], seg[:half], 24,
                                              name),
                          ops.segment_combine(vals[half:], seg[half:], 24,
                                              name)])

    got = ops.segment_combine(f32, seg, 24, "sum")
    want = kref.segment_combine_ref(f32, seg, 24, "sum")
    seg_err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-6),
          f"segment_combine sum on {TALL_ROWS} rows: max|err| {seg_err}")
    check(torch.equal(got, split(f32, "sum")),
          f"segment_combine sum on {TALL_ROWS} rows differs from its two "
          f"calls of {half} rows")
    i32 = torch.randint(-1000, 1000, (TALL_ROWS, 40), device=dev,
                        dtype=torch.int32, generator=g)
    got = ops.segment_combine(i32, seg, 24, "min")
    check(torch.equal(got, kref.segment_combine_ref(i32, seg, 24, "min"))
          and torch.equal(got, split(i32, "min")),
          f"segment_combine int32 min on {TALL_ROWS} rows differs")
    cases.append(f"segment_combine ({TALL_ROWS}, 40) into 24: f32 sum "
                 f"max|err| {seg_err:.2g} and bit for bit its two calls of "
                 f"{half} rows, int32 min exact")
    torch.cuda.synchronize()

    # end to end: W = 64 solo runs, W = 8 at Q = WIDE_Q, card against CPU
    runs = {}
    for key in WIDE_E2E:
        spec = REGISTRY[key]
        graph = spec.make_graph(WIDE_E2E_SCALE, 0)
        inputs = spec.inputs(graph, 0)
        tables = pgraph.partition_tables(graph, 64, "random",
                                         build=spec.build)
        cpu = Engine(mode="host", device="cpu").run(
            spec.factory(**inputs), pgraph.from_arrays(*tables, device="cpu"))
        pg = pgraph.from_arrays(*tables, device=dev)
        for mode in ("host", "fused"):
            ops.reset_launch_counts()
            eng = Engine(mode=mode, device=dev)
            res, wall = timed(lambda: eng.run(spec.factory(**inputs), pg))
            check(np.array_equal(np.asarray(res.output),
                                 np.asarray(cpu.output))
                  and (res.steps, res.halted) == (cpu.steps, cpu.halted)
                  and res.bytes_by_channel == cpu.bytes_by_channel
                  and res.msgs_by_channel == cpu.msgs_by_channel,
                  f"{key} at W=64 {mode} differs from the CPU run")
            spec.check(graph, pg, res, inputs)
            launches = ops.launch_counts()
            check(launches["bucket_ranks"] > 0,
                  f"{key} at W=64 {mode} launched no bucket_ranks")
            runs[f"{key} W=64 {mode}"] = dict(
                steps=res.steps, bytes=res.total_bytes, wall_ms=wall,
                launches=launches)
            eng.clear_cache()
    spec = REGISTRY["reach:basic"]
    graph = spec.make_graph(WIDE_Q_SCALE, 0)
    queries = spec.queries(graph, 0, WIDE_Q)
    prog = spec.factory(**spec.inputs(graph, 0))
    tables = pgraph.partition_tables(graph, W, "random", build=spec.build)
    cpu = Engine(mode="host", device="cpu").run_batch(
        prog, pgraph.from_arrays(*tables, device="cpu"), queries)
    ops.reset_launch_counts()
    res, wall = timed(lambda: Engine(mode="host", device=dev).run_batch(
        prog, pgraph.from_arrays(*tables, device=dev), queries))
    check(same_batch(res, cpu),
          f"reach:basic batched at Q={WIDE_Q} differs from the CPU run")
    lane_launches = ops.launch_counts()["bucket_ranks_lanes"]
    check(lane_launches > 0, f"the Q={WIDE_Q} batch launched no lanes kernel")
    runs[f"reach:basic W={W} Q={WIDE_Q}"] = dict(
        steps=res.steps, wall_ms=wall,
        launches=ops.launch_counts())

    # rows 1b and 3b: the new shapes' times beside their bounds, the plain
    # versions and a stable torch.sort of the keys
    def times(fn, plain_fn, sort_fn, what):
        """The times, and the kernel's largest difference from the plain
        version on these inputs (the check asks for none)."""
        got, want = fn(), plain_fn()
        err = max(float((a.long() - w.long()).abs().max())
                  if a.shape == w.shape else math.inf
                  for a, w in zip(got, want))
        check(len(got) == len(want) and all(
            torch.equal(a, w) for a, w in zip(got, want)),
            f"{what} differs from plain: max|err| {err}")
        return dict(ms=cuda_ms(fn), cold_ms=cuda_ms_cold(fn),
                    plain_ms=cuda_ms(plain_fn, reps=3, warmup=1),
                    library_ms=cuda_ms(sort_fn), max_abs_err=err)

    b1, shape1 = 64, (64, 1 << 18)
    row1b = {}
    for case in ("sorted", "random"):
        keys = keys_of(case, *shape1, b1)
        row1b[case] = times(
            lambda: kbucket.bucket_ranks_cuda(keys, b1),
            lambda: kref.bucket_ranks_ref(keys, b1),
            lambda: torch.sort(keys, dim=1, stable=True),
            f"row 1b bucket_ranks {case} {shape1} at B={b1}")
    bytes1 = shape1[0] * shape1[1] * 8 + shape1[0] * (b1 + 1) * 4
    b3, shape3, q3 = W, (W, 1 << 15), WIDE_Q
    row3b = {}
    for case in ("sorted", "random"):
        keys = keys_of(case, *shape3, b3)
        lanes = lanes_of(keys, q3, b3)
        real = int((keys < b3).sum())
        row3b[case] = times(
            lambda: kbucket.bucket_ranks_lanes_cuda(keys, lanes, b3),
            lambda: kref.bucket_ranks_lanes_ref(keys, lanes, b3),
            lambda: torch.sort(keys, dim=1, stable=True),
            f"row 3b bucket_ranks_lanes {case} {shape3} Q={q3} at B={b3}")
        row3b[case]["bytes"] = (shape3[0] * shape3[1] * 8 + real * q3
                                + shape3[0] * (b3 + 1) * (q3 + 1) * 4)
    e2e_launches = sum(r["launches"]["bucket_ranks"] for k, r in runs.items()
                       if k.endswith("host"))
    rows = [
        dict(name="bucket_ranks: W=64, 65 buckets (1b)", route="cuda",
             source="src/repro_torch/kernels/csrc/bucket_route.cu",
             replaces="src/repro/kernels/bucket_route.py:87",
             launches=e2e_launches,
             launches_by_path={k: r["launches"]["bucket_ranks"]
                               for k, r in runs.items() if "W=64" in k},
             max_abs_err=max(r["max_abs_err"] for r in row1b.values()),
             ms=row1b["sorted"]["ms"],
             plain_ms=row1b["sorted"]["plain_ms"],
             bound_ms=1e3 * bytes1 / HBM_BYTES_PER_S, bound_by="bytes",
             library_ms=row1b["sorted"]["library_ms"],
             library="stable torch.sort of the keys",
             cold_ms=row1b["sorted"]["cold_ms"],
             random_ms=row1b["random"]["ms"],
             random_cold_ms=row1b["random"]["cold_ms"],
             shape=list(shape1), plan=list(kbucket.launch_plan(b1, *shape1)),
             what=f"keys in [0, {b1}] of {shape1}, the wide kernel"),
        dict(name=f"bucket_ranks_lanes: Q={q3} (3b)", route="cuda",
             source="src/repro_torch/kernels/csrc/bucket_route.cu",
             replaces="src/repro/kernels/bucket_route.py:128",
             launches=lane_launches,
             launches_by_path={f"reach:basic W={W} Q={WIDE_Q} host":
                               lane_launches},
             max_abs_err=max(r["max_abs_err"] for r in row3b.values()),
             ms=row3b["sorted"]["ms"],
             plain_ms=row3b["sorted"]["plain_ms"],
             bound_ms=1e3 * row3b["sorted"]["bytes"] / HBM_BYTES_PER_S,
             bound_by="bytes", library_ms=row3b["sorted"]["library_ms"],
             library="stable torch.sort of the keys",
             cold_ms=row3b["sorted"]["cold_ms"],
             random_ms=row3b["random"]["ms"],
             random_cold_ms=row3b["random"]["cold_ms"],
             random_bound_ms=1e3 * row3b["random"]["bytes"] / HBM_BYTES_PER_S,
             shape=list(shape3) + [q3],
             plan=list(kbucket.launch_plan(b3, *shape3, q3)),
             what=f"keys in [0, {b3}] of {shape3}, {q3} lanes, half of them "
                  f"members of each real entry"),
    ]
    return dict(cases=cases, runs=runs, rows=rows)


def fault11_line(f: dict) -> str:
    r1, r3 = f["rows"]
    return (f"[2/5] fault 11: {len(f['cases'])} cases bit for bit against "
            f"plain (bucket_ranks at W = {', '.join(map(str, WIDE_WORKERS))} "
            f"and {WIDE_GLOBAL_WORKERS} (counts in global memory) and "
            f"{TALL_ROWS} rows; the lanes kernel at Q = 1024, 4096 and 6500 "
            f"(W=8; the last counted in global memory), W=64 Q=32, W=4096 "
            f"and {TALL_ROWS} rows; segment_combine on {TALL_ROWS} rows); "
            + "; ".join(f"{k}: {r['steps']} supersteps = CPU, "
                        f"{r['wall_ms']:.1f} ms, launches {r['launches']}"
                        for k, r in f["runs"].items())
            + f"; row 1b {r1['shape']} sorted {r1['ms']:.4f} ms "
            f"({r1['cold_ms']:.4f} flushed), random {r1['random_ms']:.4f} "
            f"(bound {r1['bound_ms']:.4f}, plain {r1['plain_ms']:.3f}, stable "
            f"sort {r1['library_ms']:.4f}); row 3b {r3['shape']} sorted "
            f"{r3['ms']:.4f} ms ({r3['cold_ms']:.4f} flushed), random "
            f"{r3['random_ms']:.4f} (bound {r3['bound_ms']:.4f}, plain "
            f"{r3['plain_ms']:.3f}, stable sort {r3['library_ms']:.4f})")


def timed(fn):
    """``fn()`` and its host wall time in ms, from a synced device to the
    device's end of the run."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, 1e3 * (time.perf_counter() - t0)


def same_run(a, b) -> bool:
    """Two runs of one query: equal outputs, steps, halt flags and
    per-channel bytes and messages."""
    import numpy as np

    return (np.array_equal(a[0], b[0]) and a[1:] == b[1:])


def lane_of(res, qi):
    """(output, steps, halted, bytes, msgs) of lane ``qi`` of a batched
    result."""
    return (res.outputs[qi], int(res.query_steps[qi]),
            bool(res.query_halted[qi]), res.query_bytes(qi),
            res.query_msgs(qi))


def solo_of(res):
    return (res.output, res.steps, res.halted, res.bytes_by_channel,
            res.msgs_by_channel)


def segment_edge_cases(plan, g, seg_case) -> dict:
    """``segment_combine`` against its plain version where a tiled
    reduction can break, at the pagerank plan's sender shape (W,
    e_cap = 2^20): a hub of 2^20 entries in one row, every id dropped,
    N = 1, long gaps of empty segments at tile edges, a dropped tail of
    half the row, D = 1, 3 and 5, NaN and +-inf for min/max, int32 sums
    that wrap. Exact, except float32 sums of random values (rtol 1e-4,
    atol 1e-5: reassociation only). Small-integer values make every
    other float32 sum exact in any order."""
    import torch

    w, e = plan.edge_seg.shape
    dev, n = plan.edge_seg.device, plan.u_cap
    pos = torch.arange(e, device=dev, dtype=torch.int32)
    tile = 2048  # the kernel's tile: 256 threads x 8 entries

    def rand(d=1):
        return torch.rand((w, e, d), device=dev, generator=g)

    small = torch.randint(-3, 4, (w, e, 1), device=dev, generator=g).float()
    hub = plan.edge_seg.clone()
    hub[0] = 0  # row 0: one segment of 2^20 entries
    gaps = ((pos // tile) * 5000 + (pos % tile) // 256 * 20).expand(w, e)
    half = torch.sort(torch.randint(0, n, (w, e // 2), device=dev,
                                    generator=g, dtype=torch.int32))[0]
    tail = torch.cat([half, torch.full_like(half, n)], dim=1)
    special = rand()
    pick = rand()
    special[pick < 0.01] = float("nan")
    special[(pick >= 0.01) & (pick < 0.03)] = float("inf")
    special[(pick >= 0.03) & (pick < 0.05)] = -float("inf")
    wrap = torch.randint(2**30, 2**31 - 1, (w, e, 1), device=dev,
                         generator=g, dtype=torch.int32)
    all3 = ("sum", "min", "max")
    cases = [("hub", small, hub, n, all3),
             ("hub i32", small.int(), hub, n, ("sum",)),
             ("all dropped", small, torch.full_like(hub, n), n, all3),
             ("all dropped bool", rand() < 0.5, torch.full_like(hub, -1), n,
              ("or",)),
             ("N=1", small, (plan.edge_seg >= n // 2).int(), 1, all3),
             ("tile-edge gaps", small, gaps, int(gaps.max()) + 1, all3),
             ("half-row tail", small, tail, n, all3),
             ("half-row tail bool", rand() < 0.5, tail, n, ("or",)),
             ("NaN/inf", special, plan.edge_seg, n, ("min", "max")),
             ("int32 wrap", wrap, plan.edge_seg, n, ("sum",))]
    for d in (3, 5):
        cases.append((f"D={d}", rand(d), plan.edge_seg, n, ("min", "max")))
        cases.append((f"D={d} i32", (rand(d) * 2000 - 1000).int(),
                      plan.edge_seg, n, ("sum",)))
    for what, vals, seg, nseg, combs in cases:
        for comb in combs:
            seg_case(vals, seg, nseg, comb, what=what)
    err = max(seg_case(rand(d), plan.edge_seg, n, "sum", 1e-4, 1e-5,
                       f"D={d}") for d in (1, 3, 5))
    return dict(max_abs_err=err, cases=len(cases) + 3)


def canon(labels):
    """Component labels renumbered by first occurrence (numpy): two
    labelings of one partition into components give equal arrays."""
    import numpy as np

    _, first, inv = np.unique(labels, return_index=True, return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.reshape(-1)]


def min_cases(sides, g, seg_case, label) -> list:
    """``segment_combine`` as an int32 ``min`` on sorted plan ids, exact
    against its plain version: each side ``(vals, seg, n)`` with its
    values, with INT32_MAX (the identity, what pads carry) and INT32_MIN
    among them, one hub segment over row 0, and every id dropped.
    Returns the case names."""
    import torch

    names = []
    for side, (vals, seg, n) in sides.items():
        extreme = vals.clone()
        pick = torch.rand(vals.shape, device=vals.device, generator=g)
        extreme[pick < 0.3] = INT32_MAX
        extreme[(pick >= 0.3) & (pick < 0.4)] = INT32_MIN
        hub = seg.clone()
        hub[0] = 0
        for what, v, sg in (("ids", vals, seg), ("extremes", extreme, seg),
                            ("hub", vals, hub),
                            ("all dropped", vals, torch.full_like(seg, n))):
            seg_case(v, sg, n, "min", what=f"{label} {side} {what}")
            names.append(f"{side} {what}")
    return names


def sv_min_cases(plan, n_loc, g, seg_case, label="sv") -> list:
    """:func:`min_cases` on a scatter plan, as the S-V neighbour minimum
    runs it: the sender side (per-edge vertex ids into ``u_cap``
    segments, as the channel gathers them) and the receiver side (the
    wire into ``n_loc`` segments in ``recv_sorted`` order)."""
    import torch

    dev = plan.edge_seg.device
    ids = torch.arange(plan.num_workers * n_loc, dtype=torch.int32,
                       device=dev).reshape(plan.num_workers, n_loc)
    sides = {
        "send": (ids.gather(1, plan.edge_src.long())[..., None],
                 plan.edge_seg, plan.u_cap),
        "recv": (torch.randint(0, plan.num_workers * n_loc,
                               plan.recv_sorted.shape + (1,), device=dev,
                               generator=g, dtype=torch.int32),
                 plan.recv_sorted, n_loc)}
    return min_cases(sides, g, seg_case, label)


def prop_min_cases(pplan, n_loc, g, seg_case) -> list:
    """``segment_combine`` at the three places the Propagation channel
    launches it, exact against its plain version: the local fixpoint's
    int32 ``min`` (per-edge vertex ids gathered by ``int_src`` into
    ``n_loc`` segments by ``int_dst``, as :func:`min_cases` varies
    them), the cut plan's sender and receiver (:func:`sv_min_cases`), and
    sssp's float32 ``min`` of ``dist + w`` at ``int_dst`` (a third of
    the distances +inf). Returns the case names."""
    import torch

    w = pplan.int_dst.shape[0]
    ids = torch.arange(w * n_loc, dtype=torch.int32,
                       device=pplan.int_dst.device).reshape(w, n_loc)
    names = ["cut " + x for x in sv_min_cases(pplan.cut, n_loc, g, seg_case,
                                              label="prop cut")]
    names += min_cases({"int_dst": (
        ids.gather(1, pplan.int_src.long())[..., None], pplan.int_dst,
        n_loc)}, g, seg_case, "prop")
    dist = torch.rand(pplan.int_dst.shape + (1,), device=ids.device,
                      generator=g) * 100
    dist[torch.rand(dist.shape, device=ids.device, generator=g) < 0.33] = \
        float("inf")
    seg_case(dist, pplan.int_dst, n_loc, "min", what="prop int_dst f32")
    return names + ["int_dst f32 with inf"]


def on_device_launches(fn):
    """``fn()`` and the kernels' launches during it, as the kernels count
    them on the device (``ops.device_launch_counts``), so launches
    replayed from a captured CUDA graph count too; every
    ``segment_combine`` launch must show its second kernel."""
    from repro_torch.kernels import ops

    before = ops.device_launch_counts()
    out = fn()
    after = ops.device_launch_counts()
    n = {k: after[k] - before[k] for k in after}
    join = n.pop("segment_combine_join")
    check(join == n["segment_combine"],
          f"{join} join_kernel launches for {n['segment_combine']} "
          "tile_kernel launches")
    return out, n


def launches_match(on_device: dict, want: dict, runs: int) -> bool:
    """A device-mode run's launches as the kernels count them on the
    device against the host run's: equal for a replay (``runs`` 2), at
    least as many for a first run, whose warm-up step launches too."""
    if runs == 2:
        return on_device == want
    return all(on_device[n] >= c for n, c in want.items())


def mode_runs(prog, pg):
    """``prog`` on ``pg`` in host mode and in each of ``MODE_RUNS``, as
    many runs as it says, the last reported: wall ms of ``Engine.run`` (init and
    extract included) and of the loop alone (``RunResult.wall_time_s``:
    from loading the state to the copy of the result), host overhead a
    superstep, dispatches, capture time and peak device memory (over both
    runs, the capture included). Each device-mode run must equal the host
    run bit for bit (state, supersteps, halts, bytes and msgs per
    channel), and launch each kernel as often as the host run's wrappers
    count, as the kernels count their launches on the device
    (:func:`on_device_launches`; a replayed graph launches its kernels
    without the wrappers), as must the counts the runtime adds for its
    replays. A mode run once (its first run builds the loop) launches the
    warm-up step's kernels on the device as well: there the device's
    count must be at least the host run's. Returns the rows and the fused
    engine, which keeps its captured graph for the profiled run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.pregel.engine import Engine

    def two_runs(eng, runs=2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        first = eng.run(prog, pg) if runs == 2 else None
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        (res, ms), on_device = on_device_launches(
            lambda: timed(lambda: eng.run(prog, pg)))
        row = dict(
            steps=res.steps, dispatches=res.dispatches, run_wall_ms=ms,
            loop_wall_ms=1e3 * res.wall_time_s,
            overhead_ms_per_step=1e3 * res.host_overhead_s
            / max(res.steps, 1),
            capture_s=(res if first is None else first).compile_time_s,
            launches=ops.launch_counts(), launches_on_device=on_device,
            peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30,
            step_ms=[1e3 * x for x in res.step_times_s])
        return res, row

    host, rows = two_runs(Engine(mode="host"))
    check(rows["launches_on_device"] == rows["launches"],
          f"{prog.name} host: launches on the device "
          f"{rows['launches_on_device']} != the wrappers' {rows['launches']}")
    out = {"host": rows}
    fused = None
    for label, (mode, k, runs) in MODE_RUNS.items():
        eng = Engine(mode=mode, chunk_size=k)
        res, row = two_runs(eng, runs)
        what = f"{prog.name} {label}"
        check(res.cache_hit == (runs == 2) and res.mode == mode,
              f"{what}: cache hit {res.cache_hit} in run {runs}")
        check((res.steps, res.halted) == (host.steps, host.halted)
              and res.bytes_by_channel == host.bytes_by_channel
              and res.msgs_by_channel == host.msgs_by_channel,
              f"{what}: counts differ from host mode")
        check(all(bits_equal(res.state[x], host.state[x])
                  for x in host.state), f"{what}: state differs from host")
        check(launches_match(row["launches_on_device"], rows["launches"],
                             runs),
              f"{what}: launches on the device {row['launches_on_device']} "
              f"against host's {rows['launches']} in run {runs}")
        check(row["launches"] == rows["launches"],
              f"{what}: counted launches {row['launches']} != host's "
              f"{rows['launches']}")
        kk = max(1, min(k, prog.max_steps))
        check(res.dispatches == -(-res.steps // kk),
              f"{what}: {res.dispatches} dispatches for {res.steps} steps")
        out[label] = row
        if label == "fused":
            fused = eng
        else:
            eng.clear_cache()
    return out, fused


def peak_of(fn):
    """``fn()`` and the peak device memory above what was allocated before
    it, in GiB."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**30


def same_batch(a, b) -> bool:
    """Two batched runs of the same sources: equal supersteps, per-query
    outputs, steps, halts, bytes and msgs, totals and pad audit."""
    return ((a.steps, a.halted, a.num_queries, a.bytes_by_channel,
             a.msgs_by_channel, a.num_pad_lanes, a.pad_steps, a.pad_bytes,
             a.pad_msgs) == (b.steps, b.halted, b.num_queries,
                             b.bytes_by_channel, b.msgs_by_channel,
                             b.num_pad_lanes, b.pad_steps, b.pad_bytes,
                             b.pad_msgs)
            and all(same_run(lane_of(a, qi), lane_of(b, qi))
                    for qi in range(a.num_queries)))


def batch_mode_runs(prog, pg, queries, must_launch="bucket_ranks_lanes"):
    """``Engine.run_batch`` of ``queries`` in host mode (once: it builds
    nothing) and in each of ``MODE_RUNS`` (as often as it says, the last
    run, a replay of the cached loop where there are two, reported): run
    wall (``query_init`` and extract
    included), loop wall, host overhead a superstep, dispatches, capture
    time, queries/s and peak device memory. The host run must launch
    ``must_launch`` (the path's kernel: ``bucket_ranks_lanes`` for the
    routed programs, ``segment_combine`` for the static ones). Each
    device-mode run must equal the host run bit for bit (outputs,
    per-query steps, halts, bytes and msgs, pad audit, state) and launch
    every kernel as often as the host run's wrappers count, as the kernels
    count their launches on the device. Then a batch of the first
    ``len(queries) - 12`` queries (12 pad lanes, the same bucket) must
    replay the fused loop with its own pad mask and equal the full run's
    real lanes. Returns the rows and the host run's result."""
    from repro_torch.kernels import ops
    from repro_torch.pregel.engine import Engine

    def one(eng):
        ops.reset_launch_counts()
        (res, ms), on_device = on_device_launches(
            lambda: timed(lambda: eng.run_batch(prog, pg, queries)))
        return res, dict(
            steps=res.steps, dispatches=res.dispatches, run_wall_ms=ms,
            loop_wall_ms=1e3 * res.wall_time_s,
            overhead_ms_per_step=1e3 * res.host_overhead_s
            / max(res.steps, 1), qps=len(queries) / (ms / 1e3),
            launches=ops.launch_counts(), launches_on_device=on_device,
            step_ms=[1e3 * x for x in res.step_times_s])

    (host, row), gib = peak_of(lambda: one(Engine(mode="host")))
    out = {"host": dict(row, peak_gib=gib, capture_s=0.0)}
    want = row["launches"]
    check(want[must_launch] > 0,
          f"{prog.name} batched: {must_launch} never launched")
    check(row["launches_on_device"] == want,
          f"{prog.name} batched host: launches on the device "
          f"{row['launches_on_device']} != the wrappers' {want}")
    for label, (mode, k, runs) in MODE_RUNS.items():
        eng = Engine(mode=mode, chunk_size=k)
        (first, (res, row)), gib = peak_of(
            lambda: (eng.run_batch(prog, pg, queries) if runs == 2
                     else None, one(eng)))
        first = res if first is None else first
        what = f"{prog.name} batched {label}"
        check(res.cache_hit == (runs == 2) and res.mode == mode,
              f"{what}: cache hit {res.cache_hit} in run {runs}")
        check(same_batch(res, host) and same_batch(first, host),
              f"{what}: differs from host mode")
        check(all(bits_equal(res.state[x], host.state[x])
                  for x in host.state), f"{what}: state differs from host")
        check(launches_match(row["launches_on_device"], want, runs)
              and row["launches"] == want,
              f"{what}: launches {row['launches_on_device']} on the device, "
              f"{row['launches']} counted, != host's {want}")
        kk = max(1, min(k, prog.max_steps))
        check(res.dispatches == -(-res.steps // kk),
              f"{what}: {res.dispatches} dispatches for {res.steps} steps")
        out[label] = dict(row, peak_gib=gib, capture_s=first.compile_time_s)
        if label == "fused":
            sub = eng.run_batch(prog, pg, queries[:len(queries) - 12])
            check(sub.cache_hit and sub.num_pad_lanes == 12
                  and (sub.pad_steps, sub.pad_bytes, sub.pad_msgs)
                  == (0, 0, 0)
                  and all(same_run(lane_of(sub, qi), lane_of(host, qi))
                          for qi in range(sub.num_queries)),
                  f"{what}: a batch with 12 pad lanes differs from the "
                  "full run's lanes")
            out["pad12"] = dict(queries=sub.num_queries, steps=sub.steps,
                                cache_hit=sub.cache_hit)
        eng.clear_cache()
    return out, host


def serve_runs(spec, prog, pg, graph, solos,
               per_step=(("bucket_ranks_lanes", 1),)):
    """``Engine.serve`` of the program's Poisson stream (``spec.stream``:
    ``NQ`` queries, one arrival a superstep) through ``SERVE_LANES``
    lanes of a default (fused) engine, at each of ``SERVE_CHUNKS``, two
    sessions each (the second must replay the cached loop): every record
    must equal the solo run of its query (``solos``, in query order:
    output, steps, halt, bytes and msgs), and each kernel of ``per_step``
    must launch its count a superstep the session ran, as the kernel
    counts on the device and as the runtime adds them up. Then, at the
    smaller chunk, the query with the most supersteps is made to overflow
    at its step 1 (``FaultSpec``): it is quarantined and every other query
    still equals its solo run. Returns the rows."""
    from repro_torch.kernels import ops
    from repro_torch.pregel.engine import Engine
    from repro_torch.pregel.serve import FaultSpec, QueryQueue

    schedule = spec.stream(graph, 0, NQ, rate=1.0)
    eng = Engine()

    def session(chunk, faults=None):
        ops.reset_launch_counts()
        (res, ms), on_device = on_device_launches(lambda: timed(
            lambda: eng.serve(prog, pg, QueryQueue.from_schedule(schedule),
                              num_lanes=SERVE_LANES, chunk_size=chunk,
                              faults=faults)))
        return res, ms, on_device, ops.launch_counts()

    def all_solo(res, skip=()):
        return all(r.status == "ok" and same_run(
            (r.output, r.steps, r.halted, r.bytes_by_channel,
             r.msgs_by_channel), solos[r.qid])
            for r in res.records if r.qid not in skip)

    out = {}
    for chunk in SERVE_CHUNKS:
        sessions, gib = peak_of(lambda: [session(chunk) for _ in range(2)])
        (first, *_), (res, ms, on_device, counted) = sessions
        what = f"{prog.name} serve chunk {chunk}"
        check(not first.cache_hit and res.cache_hit,
              f"{what}: the second session did not replay")
        check(res.num_queries == NQ and all_solo(first) and all_solo(res),
              f"{what}: a served query differs from its solo run")
        for kernel, n in per_step:
            check(on_device[kernel] == n * res.supersteps == counted[kernel],
                  f"{what}: {kernel} launched {on_device} on the device, "
                  f"{counted} counted, for {res.supersteps} supersteps")
        lat = res.latency_summary()
        out[f"chunk{chunk}"] = dict(
            queries=res.num_queries, lanes=SERVE_LANES,
            dispatches=res.dispatches, supersteps=res.supersteps,
            clock=res.clock, session_wall_ms=1e3 * res.wall_time_s,
            run_wall_ms=ms, qps=res.queries_per_s,
            p50_steps=lat["p50_steps"], p99_steps=lat["p99_steps"],
            p50_ms=1e3 * lat["p50_wall_s"], p99_ms=1e3 * lat["p99_wall_s"],
            median_dispatch_ms=1e3 * res.dispatch_median_s,
            stragglers=len(res.straggler_dispatches),
            capture_s=first.compile_time_s, launches_on_device=on_device,
            cache_hit=res.cache_hit, peak_gib=gib)
    victim = max(range(NQ), key=lambda qi: (solos[qi][1], -qi))
    res, _, _, _ = session(SERVE_CHUNKS[0],
                           [FaultSpec(victim, 1, "overflow")])
    check(res.failed_qids == [victim]
          and res.records[victim].status == "overflow"
          and res.records[victim].output is None
          and all_solo(res, skip=(victim,)),
          f"{prog.name} serve: the quarantined query {victim} is not "
          "isolated")
    out["quarantine"] = dict(qid=victim, chunk=SERVE_CHUNKS[0],
                             failed_qids=res.failed_qids,
                             dispatches=res.dispatches)
    eng.clear_cache()
    return out


def captured_calls(module, attr: str, run) -> list:
    """``(args, kwargs)`` of every call ``run()`` makes to
    ``module.attr``, in call order: the shapes and data a path hands a
    kernel's wrapper."""
    calls = []
    real = getattr(module, attr)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    setattr(module, attr, spy)
    try:
        run()
    finally:
        setattr(module, attr, real)
    return calls


def batched_program_runs(spec, graph, pg, must_launch, per_step,
                         solo_mode, lane_key=None):
    """One batched program of the registry at full size: ``NQ`` queries
    of its recipe run solo in ``solo_mode`` (a fused solo run captures
    its own loop first; the second run is timed: the serial baseline of
    queries/s), then ``run_batch`` in host mode and every device mode
    (:func:`batch_mode_runs`, every lane equal to its solo run; with
    ``lane_key``, that state leaf of every lane bit-identical to the solo
    run's too) and ``Engine.serve`` of the same queries
    (:func:`serve_runs`). Returns the rows, the program and the
    queries."""
    from repro_torch.pregel.engine import Engine

    prog = spec.factory(**spec.inputs(graph, 0))
    queries = spec.queries(graph, 0, NQ)
    eng = Engine(mode=solo_mode)
    solos, solo_ms, solo_loop_ms, solo_leaves = [], [], [], []
    for query in queries:
        one = spec.factory(**{spec.query_knob: query})
        if solo_mode != "host":
            eng.run(one, pg)
        res, ms = timed(lambda: eng.run(one, pg))
        check(solo_mode == "host" or res.cache_hit,
              f"{spec.key} solo {solo_mode}: not a replay")
        solos.append(solo_of(res))
        solo_ms.append(ms)
        solo_loop_ms.append(1e3 * res.wall_time_s)
        if lane_key is not None:
            solo_leaves.append(res.state[lane_key])
        eng.clear_cache()
    modes, host = batch_mode_runs(prog, pg, queries, must_launch)
    check(all(same_run(lane_of(host, qi), solos[qi]) for qi in range(NQ)),
          f"{spec.key}: a batched lane differs from its solo "
          f"{solo_mode} run")
    check(all(bits_equal(host.state[lane_key][:, qi], leaf)
              for qi, leaf in enumerate(solo_leaves)),
          f"{spec.key}: a batched lane's {lane_key} differs from its solo "
          f"{solo_mode} run")
    serving = serve_runs(spec, prog, pg, graph, solos, per_step)
    solo_qps = NQ / (sum(solo_ms) / 1e3)
    rows = dict(
        n=pg.n, steps=host.steps, query_steps=host.query_steps.tolist(),
        bytes=host.total_bytes, solo_mode=solo_mode, solo_ms=solo_ms,
        solo_loop_ms=solo_loop_ms, solo_qps=solo_qps, modes=modes,
        serving=serving,
        qps_vs_solo={m: modes[m]["qps"] / solo_qps
                     for m in ("host", *MODE_RUNS)},
        ms_per_superstep={m: modes[m]["loop_wall_ms"] / host.steps
                          for m in ("host", *MODE_RUNS)})
    return rows, prog, queries, host


def same_full(a, b) -> bool:
    """Two runs of one program: state bit for bit, supersteps, halts, and
    bytes and messages per channel."""
    return ((a.steps, a.halted, a.bytes_by_channel, a.msgs_by_channel)
            == (b.steps, b.halted, b.bytes_by_channel, b.msgs_by_channel)
            and a.state.keys() == b.state.keys()
            and all(bits_equal(a.state[k], b.state[k]) for k in a.state))


def checkpoint_runs(prog, pg, tmp: Path) -> dict:
    """``prog`` chunked at K=2 with a checkpoint every two supersteps into
    ``tmp``, then resumed from every checkpoint on the same engine: the
    checkpointed run must equal a run without checkpoints, and each resume
    must replay the cached CUDA graph (a cache hit, no new capture) and
    equal the uninterrupted run bit for bit (state, supersteps, halts,
    bytes and msgs per channel). Returns the checkpoint count, file size,
    save and load ms, the walls of the full and each resumed run, and the
    launches of the checkpointed run."""
    import os

    from repro_torch.kernels import ops
    from repro_torch.pregel import checkpoint as ckpt_io
    from repro_torch.pregel.engine import Engine

    eng = Engine(mode="chunked", chunk_size=2)
    built = eng.run(prog, pg)  # the warm-up and the capture
    plain, plain_ms = timed(lambda: eng.run(prog, pg))
    ops.reset_launch_counts()
    (full, full_ms), on_device = on_device_launches(lambda: timed(
        lambda: eng.run(prog, pg, checkpoint_every=2,
                        checkpoint_dir=str(tmp))))
    launches = ops.launch_counts()
    what = f"{prog.name} checkpointed"
    check(plain.cache_hit and full.cache_hit and same_full(full, plain),
          f"{what}: differs from the run without checkpoints")
    paths = sorted(tmp.glob("*.ckpt"))
    check(len(paths) == (full.steps - 1) // 2 and paths,
          f"{what}: {len(paths)} checkpoints for {full.steps} supersteps")
    compiles = eng.compiles
    resumed, load_ms, save_ms = [], [], []
    for path in paths:
        t0 = time.perf_counter()
        ck = ckpt_io.load(str(path))
        load_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        ckpt_io.save(ck, str(tmp / "resaved"))
        save_ms.append(1e3 * (time.perf_counter() - t0))
        res, ms = timed(lambda: eng.run(prog, pg, resume=ck))
        check(res.cache_hit and eng.compiles == compiles
              and res.resumed_from == ck.step,
              f"{what}: the resume from step {ck.step} was not a replay of "
              "the cached graph")
        check(same_full(res, full), f"{what}: the resume from step "
              f"{ck.step} differs from the uninterrupted run")
        resumed.append(dict(step=ck.step, run_wall_ms=ms,
                            loop_wall_ms=1e3 * res.wall_time_s,
                            dispatches=res.dispatches))
    eng.clear_cache()
    return dict(steps=full.steps, checkpoints=len(paths),
                bytes_per_checkpoint=os.path.getsize(paths[0]),
                save_ms=sum(save_ms) / len(save_ms),
                load_ms=sum(load_ms) / len(load_ms), full_run_wall_ms=full_ms,
                plain_run_wall_ms=plain_ms, capture_s=built.compile_time_s,
                resumed=resumed, launches=launches,
                launches_on_device=on_device)


def escalation_run(prog, pg, plain, queries=None) -> dict:
    """``prog`` (or a ``run_batch`` of ``queries``) fused from an eighth
    of every channel capacity under ``on_overflow="escalate"``: the
    trail must be non-empty and name a channel at each escalation (and
    the lanes, batched), the recovered run must equal the plain run
    ``plain`` bit for bit, and a second run of the engine must be a cache
    hit with no recovery. Returns the attempts, the trail, each capture's
    seconds (one a scale set tried), the walls, the launches of the
    escalated run and its peak device memory."""
    from repro_torch.kernels import ops
    from repro_torch.pregel.engine import Engine

    eng = Engine(cap_scales={"*": 0.125}, on_overflow="escalate")
    captures = []
    real = eng._loop

    def spy(*args):
        loop, hit = real(*args)
        if not hit:
            captures.append(loop.compile_time_s)
        return loop, hit

    eng._loop = spy
    if queries is None:
        run, same = (lambda: eng.run(prog, pg)), same_full
    else:
        run, same = (lambda: eng.run_batch(prog, pg, queries)), same_batch
    ops.reset_launch_counts()
    ((res, ms), on_device), gib = peak_of(
        lambda: on_device_launches(lambda: timed(run)))
    launches = ops.launch_counts()
    what = f"{prog.name} escalated"
    check(bool(res.recovery) and all(ev["channels"] for ev in res.recovery),
          f"{what}: trail {res.recovery} is empty or names no channel")
    check(queries is None or all(ev["qids"] for ev in res.recovery),
          f"{what}: the batched trail names no lanes")
    check(same(res, plain), f"{what}: differs from the plain run")
    check(len(captures) == len(res.recovery) + 1 and eng.cache_size == 1,
          f"{what}: {len(captures)} captures for {len(res.recovery)} "
          f"escalations, {eng.cache_size} loops cached")
    again, again_ms = timed(run)
    check(again.cache_hit and again.recovery is None and same(again, plain),
          f"{what}: the second run is not a cache hit without recovery")
    eng.clear_cache()
    return dict(attempts=len(res.recovery) + 1, trail=[
        dict(ev, channels=list(ev["channels"]),
             qids=list(ev.get("qids", ()))) for ev in res.recovery],
        capture_s=captures, run_wall_ms=ms, again_wall_ms=again_ms,
        peak_gib=gib, launches=launches, launches_on_device=on_device)


# bench-batch's programs in the smoke: one, the batched static channel.
# Phase 4 holds every batchable program's Q=32 batch lane for lane to
# its solo runs and times it batched against solo (batch_mode_runs,
# batched_program_runs), the check and the number bench-batch makes; its
# run here drives the command itself.
BENCH_BATCH_KEYS = ("pagerank:personal",)


def bench_batch_run(out_dir: Path, timeout_s: int = 420) -> dict:
    """``python -m repro_torch bench-batch --queries 32 --scale 20 --keys
    BENCH_BATCH_KEYS`` as a subprocess (each lane held to its serial run
    before anything is timed), writing ``bench_batch.json`` into
    ``out_dir``. It must exit 0. Returns its JSON and its wall."""
    import os

    path = out_dir / "bench_batch.json"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "bench-batch", "--queries",
         str(NQ), "--scale", str(FULL_SCALE), "--workers", str(W),
         "--keys", ",".join(BENCH_BATCH_KEYS), "--json", str(path)],
        cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    (out_dir / "bench_batch.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"bench-batch exited {proc.returncode}: "
          f"{(proc.stdout + proc.stderr)[-2000:]}")
    return dict(json.loads(path.read_text()), wall_s=wall)


def planned_against_hand_set(prog, pg, mode: str, k: int,
                             queries=None) -> dict:
    """``Engine(plan="auto", mode=mode, chunk_size=k)`` against an Engine
    given the plan's knobs explicitly (mode, chunk size, route_batch and
    dense_threshold; the kernels and the bucket route are the port's one
    path on the card), ``prog`` on ``pg`` (a ``run_batch``
    of ``queries`` when given), two runs each, the second reported.
    Planning must leave ``stats()`` unchanged and pick the kernels and
    the bucket route; both engines must key one loop; the second runs
    must be cache hits (device modes) and equal bit for bit (state,
    supersteps, halts, bytes and msgs per channel, per lane when
    batched), launching each kernel as often, as the wrappers count and
    as the kernels count on the device. The plan is resolved before the
    counts are read, so its probes' launches are not among them."""
    from repro_torch.kernels import ops
    from repro_torch.pregel.engine import Engine, bucket_queries

    nq = 0 if queries is None else bucket_queries(len(queries))
    what = f"{prog.name}{' batched' if queries else ''} {mode} K={k}"
    auto = Engine(plan="auto", mode=mode, chunk_size=k)
    before = auto.stats()
    plan, plan_ms = timed(lambda: auto.resolve_plan(prog, pg, nq))
    check(auto.stats() == before and auto.cache_size == 0,
          f"{what}: planning touched the engine ({auto.stats()})")
    check(plan.source == "auto" and plan.use_kernel is True
          and plan.route_impl == "bucket",
          f"{what}: the plan takes {plan.use_kernel}/{plan.route_impl}")
    hand = Engine(mode=mode, chunk_size=k, route_batch=plan.route_batch,
                  dense_threshold=plan.dense_threshold)
    check(hand.resolve_plan(prog, pg, nq).key() == plan.key(),
          f"{what}: the hand-set plan differs from the planned one")
    run = ((lambda eng: eng.run(prog, pg)) if queries is None
           else (lambda eng: eng.run_batch(prog, pg, queries)))
    rows, res = {}, {}
    for label, eng in (("planned", auto), ("hand_set", hand)):
        first = run(eng)
        ops.reset_launch_counts()
        (res[label], ms), on_device = on_device_launches(
            lambda: timed(lambda: run(eng)))
        r = res[label]
        check(mode == "host" or r.cache_hit,
              f"{what} {label}: the second run is not a cache hit")
        check(r.plan.key() == plan.key(), f"{what} {label}: ran "
              f"{r.plan.key()}, not {plan.key()}")
        rows[label] = dict(steps=r.steps, run_wall_ms=ms,
                           loop_wall_ms=1e3 * r.wall_time_s,
                           capture_s=first.compile_time_s,
                           cache_hit=r.cache_hit,
                           launches=ops.launch_counts(),
                           launches_on_device=on_device)
    a, h = res["planned"], res["hand_set"]
    same = (same_batch(a, h) if queries is not None else
            (a.steps, a.halted, a.bytes_by_channel, a.msgs_by_channel)
            == (h.steps, h.halted, h.bytes_by_channel, h.msgs_by_channel))
    check(same and all(bits_equal(a.state[x], h.state[x]) for x in h.state),
          f"{what}: the planned run differs from the hand-set run")
    p, q = rows["planned"], rows["hand_set"]
    check(p["launches"] == q["launches"] == p["launches_on_device"]
          == q["launches_on_device"],
          f"{what}: launches planned {p['launches']} (device "
          f"{p['launches_on_device']}), hand-set {q['launches']} (device "
          f"{q['launches_on_device']})")
    check(mode == "host" or set(auto._cache) == set(hand._cache),
          f"{what}: the two engines keyed different loops")
    check(auto.stats()["runs"] == 2, f"{what}: {auto.stats()}")
    auto.clear_cache()
    hand.clear_cache()
    return dict(rows, plan_ms=plan_ms, plan_key=list(plan.key()),
                steps=a.steps, bytes=a.total_bytes,
                bytes_by_channel=a.bytes_by_channel)


def plan_cli_run(out_dir: Path, cache: Path, timeout_s: int = 300) -> dict:
    """``python -m repro_torch plan --scale 20 --explain`` (its default
    programs, ``wcc:switch`` and ``sssp:basic``) as a subprocess with a
    probe cache of its own; it must exit 0 and print one decision table a
    program, the kernels and the bucket route chosen."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC),
               REPRO_TORCH_PLAN_CACHE=str(cache))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch", "plan", "--scale",
         str(FULL_SCALE), "--workers", str(W), "--explain"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=timeout_s)
    wall = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    (out_dir / "plan_explain_cli.txt").write_text(text)
    check(proc.returncode == 0,
          f"plan --explain exited {proc.returncode}: {text[-2000:]}")
    check(proc.stdout.count("plan [auto]") == 2
          and proc.stdout.count("use_kernel       True") == 2
          and proc.stdout.count("route_impl       bucket") == 2,
          f"plan --explain printed no two kernel/bucket tables: "
          f"{proc.stdout[-2000:]}")
    return dict(wall_s=wall, stdout=proc.stdout)


def planner_phase(plan_jobs, reach, sw_pg, truth, out_dir: Path,
                  cache_root: Path):
    """Phase 4's planner part: every program of ``plan_jobs`` (key ->
    (program, scale-20 partition)) planned at Q=0, the batched five also
    at Q=``NQ``; the card's probe times; every plan on the kernels and the
    bucket route; a second planner on the warm cache giving the same
    plans (``plans_explain.txt`` holds every table); ``Engine(plan=
    "auto")`` against the hand-set Engine (:func:`planned_against_hand_set`)
    for wcc:switch, sssp:basic and pagerank:scatter in ``PLAN_MODES`` and
    for ``reach`` = (program, partition, queries) batched fused;
    wcc:switch on ``sw_pg`` fused at its planned threshold (the default
    0.1: no card corpus) and at the CPU corpus fit's, both held to
    ``truth``; and ``python -m repro_torch plan --explain``
    (:func:`plan_cli_run`). Returns the details, the planned host runs'
    launches by kernel and path, and the batched run's lanes-kernel
    launches."""
    import dataclasses

    import numpy as np
    from repro_torch.algorithms import BATCHED
    from repro_torch.plan import Planner, cost_model
    from repro_torch.pregel.engine import Engine

    t = time.perf_counter()
    # explained plans: the probes decide nothing on the card, so only a
    # plan to be explained times them
    planner, plans, plan_ms = Planner(explain=True), {}, {}
    for key, (prog, pg) in plan_jobs.items():
        for q in ((0, NQ) if key in BATCHED else (0,)):
            plans[key, q], plan_ms[key, q] = timed(
                lambda: planner.plan(prog, pg, num_queries=q))
    again, unexplained = Planner(explain=True), Planner()
    for (key, q), plan in plans.items():
        check(plan.use_kernel is True and plan.route_impl == "bucket"
              and plan.dense_threshold == 0.1,
              f"{key} Q={q}: planned {plan.knobs()}")
        prog, pg = plan_jobs[key]
        check(again.plan(prog, pg, num_queries=q).to_json()
              == plan.to_json(),
              f"{key} Q={q}: a second planner on the warm cache differs")
        check(unexplained.plan(prog, pg, num_queries=q).knobs()
              == plan.knobs(),
              f"{key} Q={q}: the unexplained plan differs")
    probes = {}
    for plan in plans.values():
        fp = plan.fingerprint
        probes[fp.cache_key()] = cost_model.calibrate(fp)
    (out_dir / "plans_explain.txt").write_text("\n\n".join(
        f"{key} Q={q}\n{plan.explain()}" for (key, q), plan in plans.items()))

    def spread(name):
        vals = [1e3 * p[name] for p in probes.values()]
        return min(vals), max(vals)

    probe_ms = {n: spread(n) for n in ("route_bucket_s", "route_sort_s",
                                       "combine_kernel_s", "combine_ref_s")}
    sizes = sorted({(int(p["m_probe"]), int(p["e_probe"]))
                    for p in probes.values()})
    versus = {}
    for key in ("wcc:switch", "sssp:basic", "pagerank:scatter"):
        prog, pg = plan_jobs[key]
        versus[key] = {label: planned_against_hand_set(prog, pg, mode, k)
                       for label, (mode, k) in PLAN_MODES.items()}
    r_prog, r_pg, r_queries = reach
    versus["reach:basic batched"] = {"fused": planned_against_hand_set(
        r_prog, r_pg, "fused", 64, r_queries)}
    plan_launches = {
        kern: {f"{k} planned": v["host"]["planned"]["launches"][kern]
               for k, v in versus.items() if "host" in v
               and v["host"]["planned"]["launches"][kern]}
        for kern in ("bucket_ranks", "segment_combine")}
    plan_lanes = versus["reach:basic batched"]["fused"]["planned"][
        "launches"]["bucket_ranks_lanes"]
    check(plan_lanes > 0 and all(plan_launches.values())
          and len(plan_launches["bucket_ranks"]) >= 2,
          f"the planned runs did not launch every kernel: {plan_launches}, "
          f"bucket_ranks_lanes {plan_lanes}")
    sw_prog, sw_pg = plan_jobs["wcc:switch"]
    sw_fp = plans["wcc:switch", 0].fingerprint
    cpu_thr = cost_model.CostModel(
        dataclasses.replace(sw_fp, backend="cpu"), planner.corpus,
        {}).dense_threshold()[0]
    thr_runs = {}
    for thr in dict.fromkeys((plans["wcc:switch", 0].dense_threshold,
                              cpu_thr)):
        eng_t = Engine(mode="fused", dense_threshold=thr)
        first = eng_t.run(sw_prog, sw_pg)
        res, ms = timed(lambda: eng_t.run(sw_prog, sw_pg))
        check(res.cache_hit and np.array_equal(canon(res.output), truth)
              and np.array_equal(canon(first.output), truth),
              f"wcc:switch at threshold {thr}: labels differ from the "
              "ground truth")
        thr_runs[thr] = dict(steps=res.steps, bytes=res.total_bytes,
                             bytes_by_channel=res.bytes_by_channel,
                             run_wall_ms=ms,
                             loop_wall_ms=1e3 * res.wall_time_s,
                             capture_s=first.compile_time_s)
        eng_t.clear_cache()
    cli_plan = plan_cli_run(out_dir, cache_root / "cli")
    plan_s = time.perf_counter() - t
    detail = dict(
        plans={f"{k} Q={q}": p.to_json() for (k, q), p in plans.items()},
        cpu_corpus_threshold=cpu_thr,
        plan_ms={f"{k} Q={q}": v for (k, q), v in plan_ms.items()},
        probes=probes, probe_ms=probe_ms, probe_sizes=sizes,
        planned_vs_hand_set=versus, threshold=thr_runs,
        plan_cli_wall_s=cli_plan["wall_s"], phase_s=plan_s)
    thresholds = sorted({p.dense_threshold for p in plans.values()})
    print(f"[4/5] the planner at scale {FULL_SCALE}, W={W}: {len(plans)} "
          f"plans (21 programs at Q=0, {len(BATCHED)} at Q={NQ}), every one "
          f"use_kernel=True route_impl=bucket dense_threshold=0.1 (no card "
          f"corpus), a second planner on the warm cache identical, the "
          f"unexplained planner (no probes) the same knobs; knobs "
          f"mode/chunk/use_kernel/route_impl/"
          f"route_batch/dense_threshold: " + "; ".join(
              f"{k}{'' if q == 0 else f' Q={q}'} "
              + "/".join(str(v) for v in p.key())
              for (k, q), p in plans.items())
          + f"; thresholds {thresholds}; planning ms (cold probes first) "
          f"{min(plan_ms.values()):.1f}-{max(plan_ms.values()):.1f}; "
          f"probe times on the card at (m, e) = {sizes}, min-max over "
          f"{len(probes)} fingerprints: route bucket kernel "
          f"{probe_ms['route_bucket_s'][0]:.3f}-"
          f"{probe_ms['route_bucket_s'][1]:.3f} ms vs sort "
          f"{probe_ms['route_sort_s'][0]:.3f}-"
          f"{probe_ms['route_sort_s'][1]:.3f} ms; combine kernel "
          f"{probe_ms['combine_kernel_s'][0]:.3f}-"
          f"{probe_ms['combine_kernel_s'][1]:.3f} ms vs plain "
          f"{probe_ms['combine_ref_s'][0]:.3f}-"
          f"{probe_ms['combine_ref_s'][1]:.3f} ms", flush=True)

    def versus_row(key):
        one = next(iter(versus[key].values()))
        return f"{key}: " + ", ".join(
            f"{m} {v['planned']['run_wall_ms']:.1f} / "
            f"{v['hand_set']['run_wall_ms']:.1f} ms"
            for m, v in versus[key].items()) + (
            f" ({one['steps']} steps, launches "
            f"{one['planned']['launches_on_device']})")

    print(f"[4/5] Engine(plan=\"auto\") against the hand-set Engine with "
          f"the plan's knobs (fused, chunked K=4, host; batched reach:basic "
          f"Q={NQ} fused), bit-identical (state, supersteps, bytes and msgs "
          f"per channel), the same launches on the device, the second run a "
          f"cache hit on one key, stats() untouched by planning; run ms "
          f"planned / hand-set: " + "; ".join(versus_row(k) for k in versus)
          + f"; wcc:switch fused at the planned threshold and at the CPU "
          f"corpus fit's {cpu_thr}: " + ", ".join(
              f"{thr}: {v['steps']} steps, {v['bytes']} bytes "
              f"{v['bytes_by_channel']}, run {v['run_wall_ms']:.1f} ms "
              f"(loop {v['loop_wall_ms']:.1f})"
              for thr, v in thr_runs.items())
          + f", both = the ground truth; python -m repro_torch plan "
          f"--explain: two tables, kernels and bucket route "
          f"({cli_plan['wall_s']:.1f} s) ({plan_s:.1f} s)", flush=True)
    print("\n".join(ln for ln in cli_plan["stdout"].splitlines()
                    if ln.startswith(("plan [", "  use_kernel", "  route_impl",
                                      "    ^ one legal", "  dense_threshold",
                                      "wcc:", "sssp:"))), flush=True)
    return detail, plan_launches, plan_lanes


def lane_baseline(prog, pg, queries, union, union_row) -> dict:
    """``run_batch`` of ``queries`` fused under ``route_batch="lane"``:
    one route pass a lane (``bucket_ranks`` over the Q lanes' rows) where
    the union route runs one ``bucket_ranks_lanes`` pass. The second,
    cached run is timed; both must equal the union route's host-mode run
    ``union`` bit for bit (outputs, per-query steps, halts, bytes, msgs,
    pad audit), launch no ``bucket_ranks_lanes`` and launch each kernel as
    often as the wrappers and the runtime count, as the kernels count on
    the device. ``union_row`` is the union route's fused row;
    ``union_speedup`` is the lane route's run wall over the union
    route's, ``union_loop_speedup`` the same for the loop alone."""
    from repro_torch.pregel.engine import Engine

    eng = Engine(mode="fused", route_batch="lane")
    (first, (res, ms), on_device, counted), gib = peak_of(lambda: (
        eng.run_batch(prog, pg, queries),
        *_counted(lambda: timed(lambda: eng.run_batch(prog, pg, queries)))))
    what = f"{prog.name} lane route"
    check(res.cache_hit and res.route_batch == "lane" and res.mode == "fused",
          f"{what}: not a replay of the lane route's fused loop")
    check(same_batch(first, union) and same_batch(res, union),
          f"{what}: differs from the union route")
    check(on_device == counted and counted["bucket_ranks"] > 0
          and counted["bucket_ranks_lanes"] == 0,
          f"{what}: launches {on_device} on the device, {counted} counted")
    eng.clear_cache()
    return dict(steps=res.steps, lane_run_wall_ms=ms,
                lane_loop_wall_ms=1e3 * res.wall_time_s,
                union_run_wall_ms=union_row["run_wall_ms"],
                union_loop_wall_ms=union_row["loop_wall_ms"],
                union_speedup=ms / union_row["run_wall_ms"],
                union_loop_speedup=res.wall_time_s * 1e3
                / union_row["loop_wall_ms"],
                capture_s=first.compile_time_s, peak_gib=gib,
                union_peak_gib=union_row["peak_gib"], launches=counted)


def _counted(fn):
    """``fn()``, the kernels' launches during it as they count them on the
    device, and as the wrappers and the runtime count them."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    out, on_device = on_device_launches(fn)
    return out, on_device, ops.launch_counts()


def column_checks(calls, what: str) -> dict:
    """``segment_combine`` at each captured (values (W, E, Q·D), ids, n)
    call: against its plain version (float sum: rtol 1e-4, atol 1e-5),
    and each of the Q·D columns bit for bit against the kernel's D=1 call
    on that column alone (the combine order depends only on entry
    positions). Returns the max |error| and the shapes."""
    import torch
    from repro_torch.kernels import ops, ref as kref

    err, shapes = 0.0, []
    for (vals, ids, n, comb), _ in calls:
        out = ops.segment_combine(vals, ids, n, comb)
        want = kref.segment_combine_ref(vals, ids, n, comb)
        torch.testing.assert_close(
            out, want, rtol=1e-4, atol=1e-5,
            msg=lambda m: f"segment_combine {what} {list(vals.shape)}: {m}")
        err = max(err, float((out - want).abs().max()))
        for j in range(vals.shape[-1]):
            one = ops.segment_combine(vals[..., j:j + 1].contiguous(), ids, n,
                                      comb)
            check(bits_equal(out[..., j:j + 1].contiguous(), one),
                  f"segment_combine {what} column {j} of "
                  f"{list(vals.shape)} differs from its D=1 call")
        shapes.append(dict(shape=list(vals.shape), segments=n))
    return dict(max_abs_err=err, calls=shapes)


def amin_yardstick(v, ids, n):
    """One ``scatter_reduce_`` amin of the real entries of a (rows, E, D)
    combine into a preset buffer."""
    import torch

    idx, src, _ = real_entries(v, ids, n)
    buf = torch.full((v.shape[0] * n, v.shape[2]), float("inf"),
                     device=v.device)
    idx = idx[:, None].expand_as(src).contiguous()
    return lambda: buf.scatter_reduce_(0, idx, src, "amin",
                                       include_self=True)


def first_calls(module, attr: str, run) -> list:
    """The first call ``run()`` makes to ``module.attr`` with each ids
    tensor (a plan table: one call site) and segment count: what a path
    hands a kernel's wrapper at each of its call sites, without keeping
    every call of a long run."""
    calls = {}
    real = getattr(module, attr)

    def spy(*args, **kw):
        calls.setdefault((args[1].data_ptr(), args[2]), (args, kw))
        return real(*args, **kw)

    setattr(module, attr, spy)
    try:
        run()
    finally:
        setattr(module, attr, real)
    return list(calls.values())


def column_times(calls, yardstick=None, sides=("send", "recv")) -> dict:
    """Per side of a captured Q·D combine: the kernel (warm, L2-flushed),
    the plain version, a library call on the real entries into a preset
    buffer (``yardstick``; default ``index_add_``), and the bytes the
    function must move: each real id and its Q·D values read once, each
    output written once. Then their sums."""
    from repro_torch.kernels import ops, ref as kref

    yardstick = yardstick or index_add_yardstick
    out = {}
    for side, ((v, ids, n, comb), _) in zip(sides, calls):
        rows, _, d = v.shape
        _, src, _ = real_entries(v, ids, n)
        r = src.shape[0]
        out[side] = dict(
            shape=list(v.shape), n=n, real_entries=r,
            ms=cuda_ms(lambda: ops.segment_combine(v, ids, n, comb)),
            cold_ms=cuda_ms_cold(lambda: ops.segment_combine(v, ids, n,
                                                             comb)),
            plain_ms=cuda_ms(lambda: kref.segment_combine_ref(v, ids, n,
                                                              comb), reps=3),
            library_ms=cuda_ms(yardstick(v, ids, n)),
            bytes=r * (4 + 4 * d) + rows * n * 4 * d)
    total = {k: sum(x[k] for x in out.values()) for k in (
        "ms", "cold_ms", "plain_ms", "library_ms", "bytes")}
    total["bound_ms"] = 1e3 * total["bytes"] / HBM_BYTES_PER_S
    return dict(out, **total)


def union_lanes_times(call) -> dict:
    """``bucket_ranks_lanes`` at the captured ``_request_union`` call
    (union keys (W, U), lane membership (W, U, Q)): exact against its
    plain version, warm and L2-flushed device ms, the plain version, a
    stable ``torch.sort`` of the keys (the library yardstick), and the
    bytes it must move (key and rank of every entry, the membership of
    each real entry, the (B + 1) x (Q + 1) counts a row)."""
    import torch
    from repro_torch.kernels import ops, ref as kref

    (keys, lanes, w), _ = call
    got = ops.bucket_ranks_lanes(keys, lanes, w)
    want = kref.bucket_ranks_lanes_ref(keys, lanes, w)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          f"bucket_ranks_lanes at the _request_union shape "
          f"{list(lanes.shape)} differs from plain")
    q = lanes.shape[-1]
    real = int((keys < w).sum())
    nbytes = keys.numel() * 8 + real * q + keys.shape[0] * (w + 1) * (
        q + 1) * 4
    return dict(
        shape=list(lanes.shape), real_entries=real, max_abs_err=0.0,
        ms=cuda_ms(lambda: ops.bucket_ranks_lanes(keys, lanes, w)),
        cold_ms=cuda_ms_cold(lambda: ops.bucket_ranks_lanes(keys, lanes, w)),
        plain_ms=cuda_ms(lambda: kref.bucket_ranks_lanes_ref(keys, lanes, w),
                         reps=5),
        library_ms=cuda_ms(lambda: torch.sort(keys, dim=1, stable=True),
                           reps=10),
        bytes=nbytes, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S)


def captured_replays(fn, statics, fresh, plain, what: str,
                     replays: int = 3) -> int:
    """``fn()`` (over the ``statics`` tensors) captured into a CUDA graph
    under a scratch scope, after one warm-up call on a side stream that
    sizes the scratch, then replayed ``replays`` times, each time with
    ``fresh(r)`` copied into the statics: each replay must equal
    ``plain`` of its inputs bit for bit — what an epoch frozen into the
    capture, or a chunk mark left by an earlier replay, would break.
    Returns the number of replays."""
    import torch
    from repro_torch.kernels import scratch

    token = ("chip_smoke", what)
    try:
        with scratch.scope(token):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn()
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn()
        out = out if isinstance(out, tuple) else (out,)
        for r in range(replays):
            inputs = fresh(r)
            for st, x in zip(statics, inputs):
                st.copy_(x)
            graph.replay()
            torch.cuda.synchronize()
            want = plain(*inputs)
            want = want if isinstance(want, tuple) else (want,)
            check(all(bits_equal(a, b) for a, b in zip(out, want)),
                  f"{what}: replay {r} of the captured call differs from "
                  "plain")
        del graph
    finally:
        scratch.release(token)
    return replays


def gap_ids(shape, n: int, start: int, width: int, g):
    """Sorted int32 ids in [0, n) per row, none in [start, start + width):
    a long run of empty segments whose place the caller moves."""
    import torch

    ids = torch.randint(0, n - width, shape, device=g.device, generator=g,
                        dtype=torch.int32)
    ids = ids + width * (ids >= start).int()
    return torch.sort(ids, dim=-1)[0]


def replay_checks(dev, g, lkeys, sv_plan, n_loc, msf_recv) -> list:
    """The main path's kernels inside a captured CUDA graph, each replayed
    three times (four for ``bucket_ranks``) on fresh inputs, exact
    against plain: ``bucket_ranks`` at wcc's route-key shape (W, 2^21)
    on random, sorted, one-bucket and random keys; ``bucket_ranks_lanes``
    at the batched plane's union shape; ``segment_combine`` as the S-V
    receiver's int32 ``min`` (the wire into ``n_loc`` segments) and as
    msf's receive-side ``min_by_first`` (the captured first superstep's
    shape), both on ids with a run of 40,000 empty segments that moves
    from replay to replay, so each replay's fill pass meets chunk marks.
    Returns the case names."""
    import torch
    from repro_torch.kernels import ops, ref as kref

    names = []
    keys = torch.zeros((W, 1 << 21), dtype=torch.int32, device=dev)

    def fresh_keys(r):
        rnd = torch.randint(0, W + 1, keys.shape, device=dev,
                            dtype=torch.int32, generator=g)
        return ([rnd, torch.sort(rnd, dim=1)[0], torch.full_like(rnd, 3),
                 rnd.flip(1)][r],)

    n = captured_replays(lambda: ops.bucket_ranks(keys, W), (keys,),
                         fresh_keys, lambda k: kref.bucket_ranks_ref(k, W),
                         "bucket_ranks", 4)
    names.append(f"bucket_ranks x{n}")
    ukeys = torch.zeros_like(lkeys)
    ulanes = torch.zeros(lkeys.shape + (NQ,), dtype=torch.bool, device=dev)

    def fresh_union(r):
        k = lkeys if r == 0 else torch.randint(
            0, W + 1, lkeys.shape, device=dev, dtype=torch.int32, generator=g)
        lanes = ((torch.rand(k.shape + (NQ,), device=dev, generator=g) < 0.5)
                 & (k != W)[..., None])
        return k, lanes

    n = captured_replays(
        lambda: ops.bucket_ranks_lanes(ukeys, ulanes, W), (ukeys, ulanes),
        fresh_union, lambda k, ln: kref.bucket_ranks_lanes_ref(k, ln, W),
        "bucket_ranks_lanes")
    names.append(f"bucket_ranks_lanes x{n}")
    gap = 40_000
    shape = tuple(sv_plan.recv_sorted.shape)
    vals = torch.zeros(shape + (1,), dtype=torch.int32, device=dev)
    seg = torch.zeros(shape, dtype=torch.int32, device=dev)

    def fresh_min(r):
        v = torch.randint(INT32_MIN, INT32_MAX, vals.shape, device=dev,
                          dtype=torch.int32, generator=g)
        return v, gap_ids(shape, n_loc, 1000 + r * 30_000, gap, g)

    n = captured_replays(
        lambda: ops.segment_combine(vals, seg, n_loc, "min"), (vals, seg),
        fresh_min,
        lambda v, sg: kref.segment_combine_ref(v, sg, n_loc, "min"),
        "segment_combine int32 min")
    names.append(f"int32 min x{n}")
    mv, _, mn, _ = msf_recv
    bvals = torch.zeros_like(mv)
    bseg = torch.zeros(mv.shape[:-1], dtype=torch.int32, device=dev)

    def fresh_by_first(r):
        v = torch.rand(mv.shape, device=dev, generator=g)
        v[..., 0] = torch.randint(0, 64, mv.shape[:-1], device=dev,
                                  generator=g).float()  # tied keys
        return v.to(mv.dtype), gap_ids(tuple(bseg.shape), mn,
                                       500 + r * (mn // 4), min(gap, mn // 4),
                                       g)

    n = captured_replays(
        lambda: ops.segment_combine(bvals, bseg, mn, "min_by_first"),
        (bvals, bseg), fresh_by_first,
        lambda v, sg: kref.segment_combine_ref(v, sg, mn, "min_by_first"),
        "segment_combine min_by_first")
    names.append(f"min_by_first x{n}")
    return names


def epoch_wrap_check(dev, g) -> dict:
    """``bucket_ranks`` across the end of its epoch lap, at wcc's
    route-key shape: four calls from epoch limit - 1 on, each exact; the
    call at the limit leaves every status word zero; the epoch then runs
    1, 2 — all on the device, no host-side reset. Then the same four
    launches inside a WHILE node (:func:`epoch_wrap_in_a_while`)."""
    import torch
    from repro_torch.kernels import bucket_route as kbucket
    from repro_torch.kernels import ops, ref as kref
    from repro_torch.kernels import scratch

    keys = torch.randint(0, W + 1, (W, 1 << 21), device=dev,
                         dtype=torch.int32, generator=g)
    want = kref.bucket_ranks_ref(keys, W)
    limit = kbucket.epoch_limit()
    token = ("chip_smoke", "epoch wrap")
    try:
        with scratch.scope(token):
            ops.bucket_ranks(keys, W)
            sc = kbucket.scratch_of(dev)
            torch.cuda.synchronize()
            sc.ctrl[0] = (limit - 2) << 32
            epochs = []
            for call in range(4):
                got = ops.bucket_ranks(keys, W)
                torch.cuda.synchronize()
                epochs.append((int(sc.ctrl[0]) >> 32))
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"bucket_ranks at epoch wrap call {call} differs from "
                      "plain")
                if call == 1:
                    check(not bool(sc.status.any()),
                          "the call at the epoch limit left status words")
            check(epochs == [limit - 1, 0, 1, 2] and int(sc.ctrl[1]) == 0,
                  f"epoch words after the wrap: {epochs}")
    finally:
        scratch.release(token)
    return dict(limit=limit, stored_epochs=epochs,
                status_words=int(sc.status.numel()),
                in_a_while=epoch_wrap_in_a_while(dev, keys, want))


def counting_loops(nest, go, n, out) -> None:
    """Under an IF node on ``go``: a WHILE that counts to ``n[0]``; a WHILE
    of ``n[1]`` rounds that holds a WHILE of ``n[2]`` iterations, counting
    both; a WHILE whose condition is false on entry. The four counts go
    to ``out``."""
    import torch

    with nest.if_node(go):
        a = torch.zeros((), dtype=torch.int32, device=go.device)
        more_a = a < n[0]
        with nest.while_node(more_a):
            a.add_(1)
            more_a.copy_(a < n[0])
        rounds = torch.zeros_like(a)
        inner = torch.zeros_like(a)
        more_r = rounds < n[1]
        with nest.while_node(more_r):
            j = torch.zeros_like(a)
            more_j = j < n[2]
            with nest.while_node(more_j):
                j.add_(1)
                inner.add_(1)
                more_j.copy_(j < n[2])
            rounds.add_(1)
            more_r.copy_(rounds < n[1])
        z = torch.zeros_like(a)
        never = z > 0
        with nest.while_node(never):
            z.add_(1)
            never.copy_(z < 100)
        out.copy_(torch.stack([a, rounds, inner, z]))


def while_node_check(dev) -> dict:
    """The WHILE conditional node (``kernels.graph_if``) in one captured
    graph, before any program runs on it: a WHILE inside an IF, a WHILE
    inside a WHILE inside an IF, and a zero-trip WHILE
    (:func:`counting_loops`), replayed from fresh trip counts, once with
    the IF false: every loop runs exactly as often as its condition says
    and a false IF runs none of them."""
    import torch
    from repro_torch.kernels import graph_if

    go = torch.ones((), dtype=torch.bool, device=dev)
    n = torch.zeros(3, dtype=torch.int32, device=dev)
    out = torch.zeros(4, dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    nest = graph_if.Nest(dev)
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(torch.cuda.current_stream(dev))
    replays = []
    try:
        with torch.cuda.graph(graph, stream=side):
            try:
                counting_loops(nest, go, n, out)
            finally:
                nest.close()
        depth = len(nest.streams)
        check(depth == 3, f"the WHILE check captured {depth} body depths")
        for trips, run in (((5, 3, 7), True), ((1, 6, 0), True),
                           ((2, 2, 2), False), ((64, 1, 33), True)):
            n.copy_(torch.tensor(trips, dtype=torch.int32))
            go.fill_(run)
            out.fill_(-1)
            graph.replay()
            torch.cuda.synchronize()
            a, r, j = trips
            want = [a, r, r * j, 0] if run else [-1] * 4
            got = out.tolist()
            check(got == want, f"WHILE nodes with trips {trips}, IF {run}: "
                  f"counted {got}, want {want}")
            replays.append(dict(trips=trips, if_taken=run, counts=got))
    finally:
        del graph
        nest.release()
    return dict(depths=depth, replays=replays)


def epoch_wrap_in_a_while(dev, keys, want) -> dict:
    """``bucket_ranks`` across the end of its epoch lap inside a WHILE
    node: one replay of a captured graph whose WHILE body launches the
    kernel four times from epoch limit - 1 on, each launch exact (the
    body counts the wrong ranks and counts on the device), the kernel
    counting four launches on the device, the epoch at 2 after."""
    import torch
    from repro_torch.kernels import bucket_route as kbucket
    from repro_torch.kernels import graph_if, ops, scratch

    limit = kbucket.epoch_limit()
    token = ("chip_smoke", "epoch wrap in a WHILE")
    trips = torch.zeros((), dtype=torch.int32, device=dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.int32, device=dev)
    side = torch.cuda.Stream(dev)
    nest = graph_if.Nest(dev)
    graph = torch.cuda.CUDAGraph()
    try:
        with scratch.scope(token):
            ops.bucket_ranks(keys, W)  # sizes the scope's scratch
            sc = kbucket.scratch_of(dev)
            torch.cuda.synchronize()
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.graph(graph, stream=side):
                try:
                    i = torch.zeros((), dtype=torch.int32, device=dev)
                    more = i < trips
                    with nest.while_node(more):
                        rank, counts = ops.bucket_ranks(keys, W)
                        bad.add_((rank != want[0]).sum()
                                 + (counts != want[1]).sum())
                        i.add_(1)
                        more.copy_(i < trips)
                    done.copy_(i)
                finally:
                    nest.close()
            sc.ctrl[0] = (limit - 2) << 32  # the next launch runs limit - 1
            trips.fill_(4)
            _, launched = on_device_launches(
                lambda: (graph.replay(), torch.cuda.synchronize()))
            epoch = int(sc.ctrl[0]) >> 32
            check(int(done) == 4 and int(bad) == 0,
                  f"bucket_ranks in a WHILE across the epoch limit: "
                  f"{int(done)} launches, {int(bad)} wrong ranks/counts")
            check(launched["bucket_ranks"] == 4,
                  f"the WHILE body launched bucket_ranks "
                  f"{launched['bucket_ranks']} times on the device, not 4")
            check(epoch == 2 and int(sc.ctrl[1]) == 0,
                  f"epoch words after the WHILE: {epoch}, {int(sc.ctrl[1])}")
    finally:
        del graph
        nest.release()
        scratch.release(token)
    return dict(launches=4, stored_epoch=epoch)


def strong_components(graph):
    """Strongly connected component labels of a directed EdgeList, by
    scipy (the scale-20 ground truth; held to ``oracles.scc_oracle`` at
    scale 12 first)."""
    import numpy as np
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    e = np.asarray(graph.edges)
    adj = coo_matrix((np.ones(len(e), np.float32), (e[:, 0], e[:, 1])),
                     shape=(graph.n, graph.n)).tocsr()
    return connected_components(adj, directed=True, connection="strong")[1]


def bits_equal(a, b) -> bool:
    """Bit-identical tensors (NaN payloads and -0.0 included)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def captured_reduces(run) -> list:
    """``(vals, ids, n, combiner)`` of every call ``run()`` makes to the
    channels' order-sensitive dispatch (``kernels.ops.segment_reduce``),
    in call order: the shapes and data a path gives the kernel."""
    from repro_torch.core import combiners as cb
    from repro_torch.kernels import ops

    calls = []
    real = ops.segment_reduce

    def spy(vals, ids, n, combiner, **kw):
        calls.append((vals, ids, n, cb.get(combiner)))
        return real(vals, ids, n, combiner, **kw)

    ops.segment_reduce = spy
    try:
        run()
    finally:
        ops.segment_reduce = real
    return calls


def stable_sorted(vals, ids):
    """``(vals, ids)`` in the order of a stable sort of ``ids`` along the
    last axis: what the dispatch hands the kernel."""
    import torch

    ids, order = torch.sort(ids, dim=-1, stable=True)
    return vals.gather(1, order[..., None].expand_as(vals)), ids


def by_first_cases(calls, g) -> dict:
    """``segment_combine`` as ``min_by_first`` against its plain version
    (the sorted scan of ``core.segmented``), bit for bit, at the msf
    plan's shapes: the first superstep's candidate combine, sender side
    (the (W, e_cap, 4) rows (weight, component, src, dst) sorted by
    compact segment; R-MAT float32 weights tie at this scale) with D = 1,
    3, 4, 5 and int32, one hub segment over a whole row of tied keys (the
    last occurrence must win), +-inf, NaN and -0.0 keys, every id
    dropped; the receiver side (the wire, unsorted) through the
    order-sensitive dispatch, twice bit-identical. Returns the case
    names and shapes."""
    import torch
    from repro_torch.core import combiners as cb
    from repro_torch.kernels import ops, ref as kref

    (send, send_ids, m, _), (recv, recv_ids, n_loc, _) = calls[:2]
    vals, seg = stable_sorted(send, send_ids)
    w, e, _ = vals.shape
    dev = vals.device
    names = []

    def case(what, v, sg, n):
        got = ops.segment_combine(v, sg, n, cb.MIN_BY_FIRST)
        want = kref.segment_combine_ref(v, sg, n, cb.MIN_BY_FIRST)
        check(bits_equal(got, want),
              f"min_by_first {what} differs from the plain version")
        names.append(what)
        return got

    case("candidates D=4", vals, seg, m)
    case("D=1", vals[..., :1].contiguous(), seg, m)
    case("D=3", vals[..., :3].contiguous(), seg, m)
    extra = torch.rand((w, e, 1), device=dev, generator=g)
    case("D=5", torch.cat([vals, extra], dim=-1), seg, m)
    case("int32 D=4", (vals * 1000).int(), seg, m)
    hub = seg.clone()
    hub[0] = 7
    tied = vals.clone()
    tied[..., 0] = 0.5
    got = case("hub of tied keys", tied, hub, m)
    check(bits_equal(got[0, 7], tied[0, -1]),
          "min_by_first hub: the last of the tied keys did not win")
    special = vals.clone()
    pick = torch.rand((w, e), device=dev, generator=g)
    key = special[..., 0]
    key[pick < 0.01] = float("nan")
    key[(pick >= 0.01) & (pick < 0.03)] = float("inf")
    key[(pick >= 0.03) & (pick < 0.05)] = -float("inf")
    key[(pick >= 0.05) & (pick < 0.07)] = -0.0
    case("NaN/+-inf/-0.0 keys", special, seg, m)
    got = case("all dropped", vals, torch.full_like(seg, m), m)
    check(bool((got[..., 0] == float("inf")).all()
               and (got[..., 1:] == 0).all()),
          "min_by_first all dropped: not identity_like")
    first = ops.segment_reduce(recv, recv_ids, n_loc, cb.MIN_BY_FIRST)
    again = ops.segment_reduce(recv, recv_ids, n_loc, cb.MIN_BY_FIRST)
    want = cb.MIN_BY_FIRST.segment_reduce(recv, recv_ids, n_loc)
    check(bits_equal(first, want) and bits_equal(first, again),
          "min_by_first receiver side through the dispatch differs from "
          "plain or between two runs")
    names.append("recv dispatch x2")
    return dict(cases=names, send_shape=list(vals.shape), send_segments=m,
                recv_shape=list(recv.shape), recv_segments=n_loc)


def prod_cases(plan, n_loc, g, seg_case) -> list:
    """``segment_combine`` as ``prod`` against its plain version on the
    pagerank plan (sender and receiver side): int32 exact (wrapping),
    float32 of signs and powers of two exact (the exponent stays in
    range), float32 in [0.999, 1.001] within rtol 1e-4 (reassociation of
    up to a hub's in-degree of products)."""
    import torch

    names = []
    dev = plan.edge_seg.device
    for side, (seg, n) in (("send", (plan.edge_seg, plan.u_cap)),
                           ("recv", (plan.recv_sorted, n_loc))):
        shape = tuple(seg.shape) + (1,)
        pick = torch.rand(shape, device=dev, generator=g)
        signs = torch.where(pick < 0.5, 1.0, -1.0)
        pow2 = torch.where(pick < 0.01, 2.0, torch.where(pick > 0.99, 0.5,
                                                         1.0)) * signs
        near1 = 0.999 + 0.002 * torch.rand(shape, device=dev, generator=g)
        ints = torch.randint(-3, 4, shape, device=dev, generator=g,
                             dtype=torch.int32)
        seg_case(pow2, seg, n, "prod", what=f"prod {side} powers of two")
        seg_case(ints, seg, n, "prod", what=f"prod {side} int32")
        seg_case(near1, seg, n, "prod", 1e-4, 0.0, f"prod {side} near 1")
        names += [f"{side} powers of two", f"{side} int32",
                  f"{side} near 1"]
    return names


def real_entries(v, ids, n):
    """The entries of a (rows, E, D) combine whose id lies in [0, n): flat
    row-major output index, their (R, D) values and the nonempty segment
    count."""
    import torch

    rows, _, d = v.shape
    keep = (ids >= 0) & (ids < n)
    idx = (ids.long() + torch.arange(rows, device=v.device)[:, None] * n)[
        keep]
    return idx, v.reshape(-1, d)[keep.reshape(-1)], int(idx.unique().numel())


def index_add_yardstick(v, ids, n):
    """One ``index_add_`` of the real entries into a preset buffer."""
    import torch

    idx, src, _ = real_entries(v, ids, n)
    buf = torch.zeros((v.shape[0] * n, v.shape[2]), device=v.device)
    return lambda: buf.index_add_(0, idx, src)


def two_pass_yardstick(v, ids, n):
    """``min_by_first`` in plain PyTorch calls on the real entries: a
    ``scatter_reduce_`` amin of the keys, a ``scatter_reduce_`` amax of
    the position among each segment's tied minima (the later wins), then
    a gather of the winning rows."""
    import torch

    idx, src, _ = real_entries(v, ids, n)
    key = src[:, 0].contiguous()
    pos = torch.arange(idx.numel(), device=v.device)
    kbuf = torch.empty(v.shape[0] * n, device=v.device)
    pbuf = torch.empty(v.shape[0] * n, dtype=torch.int64, device=v.device)

    def fn():
        kbuf.fill_(float("inf"))
        kbuf.scatter_reduce_(0, idx, key, "amin", include_self=True)
        tie = key == kbuf[idx]
        pbuf.fill_(-1)
        pbuf.scatter_reduce_(0, idx, torch.where(tie, pos, -1), "amax",
                             include_self=True)
        return src[pbuf.clamp(min=0)]

    return fn


def dispatch_times(calls, yardstick) -> dict:
    """Per side of a path's order-sensitive combine (as captured): the
    kernel alone on the stable-sorted inputs (warm, L2-flushed), the
    dispatch (sort, gather and kernel), the plain version, the yardstick,
    and the bytes the function must move — each real id and value read
    once, each output written once; ``min_by_first`` reads each real id
    and key (column 0) once and each winning row once more, as the
    kernel's header counts. Then their sums over both sides."""
    from repro_torch.kernels import ops

    sides = {}
    for side, (v, ids, n, comb) in zip(("send", "recv"), calls):
        vs, ss = stable_sorted(v, ids)
        rows, _, d = v.shape
        _, src, winners = real_entries(v, ids, n)
        r = src.shape[0]
        read = (r * 8 + winners * 4 * d if comb.name == "min_by_first"
                else r * (4 + 4 * d))
        sides[side] = dict(
            shape=list(v.shape), n=n, real_entries=r, nonempty=winners,
            ms=cuda_ms(lambda: ops.segment_combine(vs, ss, n, comb)),
            cold_ms=cuda_ms_cold(lambda: ops.segment_combine(vs, ss, n,
                                                             comb)),
            dispatch_ms=cuda_ms(lambda: ops.segment_reduce(v, ids, n, comb)),
            plain_ms=cuda_ms(lambda: comb.segment_reduce(v, ids, n), reps=3),
            library_ms=cuda_ms(yardstick(v, ids, n)),
            bytes=read + rows * n * 4 * d)
    total = {k: sum(x[k] for x in sides.values()) for k in (
        "ms", "cold_ms", "dispatch_ms", "plain_ms", "library_ms", "bytes")}
    total["bound_ms"] = 1e3 * total["bytes"] / HBM_BYTES_PER_S
    return dict(sides, **total)


def profile_runs(jobs, out_dir: Path) -> dict:
    """One traced run per (key, run function, untraced wall ms) under
    torch.profiler, and the kernels and aten ops that take the device
    time. Two busy shares, both for one stream: ``busy_share`` is the
    traced run's device time over its own wall time (one run, slowed by
    the profiler); ``busy_vs_untraced`` is the same device time over the
    wall time of the untraced phase-4 run of that program (two runs).
    Each run's kernel launches are recorded twice, from the trace's
    events (``LAUNCH_EVENTS``) and as the kernels count them on the
    device, and not checked against each other: the trace is no count of
    a replayed graph's launches inside its IF nodes."""
    from torch.autograd import DeviceType

    def dev_us(e, total=False):
        name = "device_time_total" if total else "self_device_time_total"
        return getattr(e, name)

    out = {}
    for key, fn, untraced_ms in jobs:
        ((res, wall_ms), events), on_device = on_device_launches(
            lambda: traced(lambda: timed(fn)))
        kernels = [e for e in events if e.device_type == DeviceType.CUDA]
        in_trace = {name: sum(e.count for e in kernels if mark in e.key)
                    for name, mark in LAUNCH_EVENTS.items()}
        ops_ = [e for e in events if e.device_type == DeviceType.CPU
                and e.key.startswith("aten::")]
        device_ms = sum(dev_us(e) for e in kernels) / 1e3
        top_k = sorted(kernels, key=dev_us, reverse=True)[:12]
        top_o = sorted(ops_, key=lambda e: dev_us(e, True), reverse=True)[:12]
        out[key] = dict(
            steps=res.steps, wall_ms=wall_ms, device_ms=device_ms,
            busy_share=device_ms / wall_ms, untraced_wall_ms=untraced_ms,
            busy_vs_untraced=device_ms / untraced_ms,
            launches_in_trace=in_trace, launches_on_device=on_device,
            kernels=[(e.key[:90], dev_us(e) / 1e3, e.count) for e in top_k],
            aten_ops=[(e.key, dev_us(e, True) / 1e3, e.count) for e in top_o])
        rows = "\n".join(f"{ms:10.3f} ms {n:6d}x  {k}"
                         for k, ms, n in out[key]["kernels"] +
                         [("--- aten ops (device time incl. children)", 0, 0)]
                         + out[key]["aten_ops"])
        stem = key.replace(":", "_").replace(" ", "_")
        (out_dir / f"profile_{stem}.txt").write_text(
            f"{key}: {res.steps} steps, traced wall {wall_ms:.3f} ms, device "
            f"{device_ms:.3f} ms, busy {device_ms / wall_ms:.3f}; untraced "
            f"wall {untraced_ms:.3f} ms, device/untraced "
            f"{device_ms / untraced_ms:.3f}\n{rows}\n")
    return out


DIST_WORLD = 4  # ranks of the multi-device phase (W of its runs)
DIST_QUERIES = 8


def dist_transport_start(transport: str):
    """Start ``python -m repro_torch.launch.jobs`` as a subprocess: W=4
    ranks of one ``transport`` group at scale 20 run the multi-device job
    set (``jobs.default_jobs``) in host mode, ``Engine(backend="dist")``;
    rank 0's summaries and every rank's agreement go to a pickle under
    ``build/``. Returns what :func:`dist_transport_finish` takes."""
    import os

    path = ROOT / "build" / f"dist_{transport}.pkl"
    path.parent.mkdir(parents=True, exist_ok=True)
    log = open(ROOT / "build" / f"dist_{transport}.log", "w")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.jobs", "--out", str(path),
         "--world", str(DIST_WORLD), "--scale", str(FULL_SCALE),
         "--queries", str(DIST_QUERIES), "--transport", transport,
         "--timeout", "120"], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    return transport, proc, path, log, time.perf_counter()


def dist_transport_finish(started, out_dir: Path, timeout_s: int) -> dict:
    """Wait for a started group (killed past ``timeout_s`` from its
    start); it must exit 0. Returns its pickle and its wall."""
    import pickle

    transport, proc, path, log, t0 = started
    try:
        rc = proc.wait(timeout=max(1.0, timeout_s - (time.perf_counter()
                                                     - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    wall = time.perf_counter() - t0
    log.close()
    text = Path(log.name).read_text()
    (out_dir / f"dist_{transport}.log").write_text(text)
    check(rc == 0, f"the {transport} group exited {rc}: {text[-3000:]}")
    with open(path, "rb") as f:
        got = pickle.load(f)
    path.unlink()
    return dict(got, wall_s=wall)


def dist_phase(out_dir: Path, smi: str) -> dict:
    """The multi-device phase: ``Engine(backend="dist")``, one worker a
    process, W=4 ranks on the card at scale 20 over gloo (and over NCCL,
    one card a rank, when there are 4 cards). Each job — ``wcc:basic``,
    ``sv:composed``, ``sssp:basic`` and ``pagerank:scatter``; ``wcc:switch``,
    ``sv:composed`` and ``sssp:basic`` on the ``degree`` partition mirrored
    at 8 and unmirrored; batched ``sssp:basic`` and ``pj:reqresp`` at
    Q=8 — is held bit for bit to a single-process ``Engine(mode="host")``
    run at W=4 on the same card and partition (outputs, final state,
    supersteps, halts, bytes and messages per channel and per lane, each
    kernel's launches on every rank against the local wrappers' count),
    every rank agreeing with rank 0; the four `random`-partition solo
    outputs meet their oracles and each mirrored output equals its
    unmirrored twin. The ranks partition their graphs while this process
    partitions its own; the local runs wait until the ranks are done, so
    no two runs share the card. A gloo group of ranks that share one card
    is a correctness run, not a scaling number."""
    import numpy as np
    import torch

    from repro_torch.launch import jobs as J

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    started = dist_transport_start("gloo")
    jobs = J.default_jobs(FULL_SCALE, DIST_QUERIES, DIST_WORLD)
    problems = J.Problems()
    for job in jobs:  # the host half, beside the ranks'
        problems.tables(job)
    runs = {"gloo": dist_transport_finish(started, out_dir, 600)}
    if cards >= DIST_WORLD:
        runs["nccl"] = dist_transport_finish(
            dist_transport_start("nccl"), out_dir, 600)
    check([j.name for j in runs["gloo"]["jobs"]] == [j.name for j in jobs],
          "the ranks ran another job list")
    dev = torch.device("cuda")
    rows, outputs = {}, {}
    for i, job in enumerate(jobs):
        local = J.run_job(job, dev, problems=problems)
        outputs[job] = local["output"]
        if job.partitioner == "random":
            J.check_oracle(job, local, dev, problems)
        elif job.mirror_threshold is None:
            twin = dataclasses.replace(job, mirror_threshold=8)
            check(np.array_equal(np.asarray(outputs[twin]),
                                 np.asarray(local["output"])),
                  f"{twin.name}: mirrored output differs from unmirrored")
        row = dict(steps=local["steps"], local_wall_s=local["wall_s"],
                   local_ms_per_step=local["ms_per_step"],
                   local_peak_bytes=local["peak_bytes"],
                   launches=local["launches"])
        for transport, run in runs.items():
            check(all(not d[i] for d in run["agree"]),
                  f"{job.name}: the {transport} ranks disagree: "
                  f"{[d[i] for d in run['agree']]}")
            got = run["ranks"][0][i]
            diff = J.differences(got, local)
            check(not diff, f"{job.name} on a {transport} group differs "
                  f"from the local run in {diff}")
            walls = [r[i]["wall_s"] for r in run["ranks"]]
            row[transport] = dict(
                wall_s=walls, ms_per_step=1e3 * max(walls) / got["steps"],
                peak_bytes=[r[i]["peak_bytes"] for r in run["ranks"]],
                collectives=got["collectives"],
                collective_bytes=got["collective_bytes"])
        check(sum(local["launches"].values()) > 0,
              f"{job.name}: no kernel launched")
        rows[job.name] = row
    return dict(rows=rows, cards=cards, smi=smi, world=DIST_WORLD,
                transports={t: dict(seconds=r["seconds"], wall_s=r["wall_s"])
                            for t, r in runs.items()},
                nccl_not_run=None if "nccl" in runs else
                f"{cards} card(s), NCCL takes one a rank",
                seconds=time.perf_counter() - t0)


def dist_lines(d: dict) -> list:
    """The phase's printed lines: transports, device count, each job's
    walls and ms a superstep on both backends, peak memory per rank."""
    gb = 1 / 2**30
    head = (f"[4/5] multi-device phase: W={d['world']} ranks, scale "
            f"{FULL_SCALE}, Engine(backend=\"dist\", mode=\"host\") "
            f"against one process's Engine(mode=\"host\") at W="
            f"{d['world']}, bit for bit with the same launches on every "
            f"rank | {d['smi']} | torch.cuda.device_count() {d['cards']} | "
            + "; ".join(f"{t}: ranks' spawn {v['seconds']:.1f} s, "
                        f"subprocess {v['wall_s']:.1f} s"
                        for t, v in d["transports"].items())
            + (f"; nccl: not run ({d['nccl_not_run']})"
               if d["nccl_not_run"] else "")
            + f" | phase {d['seconds']:.1f} s (the gloo walls: {d['world']}"
            f" ranks sharing one card, a correctness run, not a scaling "
            f"number)")
    lines = [head]
    for name, r in d["rows"].items():
        parts = [f"{name}: {r['steps']} supersteps, local wall "
                 f"{1e3 * r['local_wall_s']:.1f} ms ("
                 f"{r['local_ms_per_step']:.2f} ms a superstep, peak "
                 f"{gb * r['local_peak_bytes']:.2f} GiB)"]
        for t in d["transports"]:
            x = r[t]
            parts.append(
                f"{t} wall (slowest rank) {1e3 * max(x['wall_s']):.1f} ms "
                f"({x['ms_per_step']:.2f} ms a superstep, "
                f"{x['collectives']} collectives, "
                f"{x['collective_bytes'] / 2**20:.1f} MiB sent a rank, peak "
                f"per rank {'/'.join(f'{gb * p:.2f}' for p in x['peak_bytes'])}"
                f" GiB)")
        lines.append("[4/5]   " + "; ".join(parts) + f" | {d['smi']}")
    return lines


# -- the LM serving path (models/, serve/decode) ------------------------------
LM_ARCH = "qwen2-moe-a2.7b"  # the largest registry model one card holds whole
LM_REQUESTS, LM_PROMPT, LM_NEW = 4, 512, 32  # the served run
LM_SWEEP = (1, 8, 32)  # decode batch sizes timed
LM_SWEEP_STEPS = 8  # timed decode steps a batch size (after one warm step)
LM_CARD_TOL = 1e-3  # smoke forward: card against the CPU, same weights
LM_DECODE_TOL = 2e-3  # decode against the full forward
BF16_FLOP_S = 989e12  # H100 SXM dense bf16 (data sheet)


def _moe_counter(dropped: list):
    """An ``moe_impl`` that records the (token, choice) pairs each MoE
    layer's capacity drops (0-d tensors, no host sync)."""
    from repro_torch.models import layers

    def moe(cfg, lp, x):
        stats = {}
        y = layers.moe_layer(cfg, lp, x, stats=stats)
        dropped.append(stats["dropped"])
        return y
    return moe


def _lm_close(got, want, tol, what):
    import torch

    err = float((got.float() - want.float()).abs().max())
    try:
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    except AssertionError as e:
        raise SmokeFailure(f"{what}: {e}") from None
    return err


def _decode_against_full(cfg, params, toks, s, dev, what, moe_impl=None):
    """Prefill ``toks[:, :s]`` and decode the rest one token a step; each
    step's logits within LM_DECODE_TOL of the full forward's. Returns the
    largest error and the prefill's last logits."""
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D

    b, total = toks.shape
    full, _ = M.forward(cfg, params, {"tokens": toks}, moe_impl=moe_impl)
    cache = M.init_cache(cfg, b, total, device=dev)
    last, cache = D.make_prefill_step(cfg, moe_impl)(
        params, {"tokens": toks[:, :s]}, cache)
    step = D.make_decode_step(cfg, moe_impl)
    err = 0.0
    for pos in range(s, total):
        _, logits, cache = step(params, cache, toks[:, pos:pos + 1], pos)
        err = max(err, _lm_close(logits, full[:, pos], LM_DECODE_TOL,
                                 f"{what} decode at {pos}"))
    return err, last


def lm_smoke_configs(dev) -> dict:
    """Every registry smoke config, float32: one set of weights drawn on
    the CPU and moved to the card; the card's forward against the CPU's,
    prefill + 4 decode steps against the full forward, greedy generate
    twice bit-identical."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model as M, params as Pm
    from repro_torch.serve import decode as D

    rows = {}
    for i, (arch, spec) in enumerate(registry.ARCHS.items()):
        cfg = spec.smoke
        cpu_p = Pm.init_params(cfg, torch.Generator().manual_seed(i),
                               device="cpu")
        p = Pm.tree_map(lambda t: t.to(dev), cpu_p)
        g = torch.Generator().manual_seed(100 + i)
        toks = torch.randint(0, cfg.vocab, (2, 13), generator=g)
        batch = {"tokens": toks}
        if cfg.frontend == "audio_frames":
            batch = {"embeds": 0.02 * torch.randn(2, 13, cfg.d_model,
                                                  generator=g)}
        elif cfg.frontend == "vision_patches":
            batch["embeds"] = 0.02 * torch.randn(
                2, cfg.frontend_tokens, cfg.d_model, generator=g)
        want, _ = M.forward(cfg, cpu_p, batch)
        got, _ = M.forward(cfg, p, {k: v.to(dev) for k, v in batch.items()})
        card_err = _lm_close(got.cpu(), want, LM_CARD_TOL,
                             f"{arch} smoke forward, card against CPU")
        toks = toks.to(dev)
        dec_err, _ = _decode_against_full(cfg, p, toks, 9, dev,
                                          f"{arch} smoke")
        a = D.generate(cfg, p, toks[:, :9], 8)
        b = D.generate(cfg, p, toks[:, :9], 8)
        check(torch.equal(a, b), f"{arch} smoke: greedy generate twice "
                                 f"differs")
        rows[arch] = dict(card_vs_cpu_err=card_err, decode_err=dec_err,
                          tokens=a.tolist())
    return rows


def lm_full_width_depth2(dev) -> dict:
    """qwen2-moe-a2.7b at full width, 2 of its 24 layers, float32: the
    prefill's last logits equal the full forward's bit for bit (the same
    tokens through the same capacity); at capacity_factor E/k (no drops)
    8 decode steps equal the full forward within LM_DECODE_TOL."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model as M, params as Pm
    from repro_torch.serve import decode as D

    cfg = dataclasses.replace(registry.ARCHS[LM_ARCH].config, n_layers=2,
                              dtype="float32")
    g = torch.Generator(device=dev).manual_seed(1)
    p = Pm.init_params(cfg, g, torch.float32, dev)
    b, s, new = 4, 64, 8
    toks = torch.randint(0, cfg.vocab, (b, s + new), device=dev, generator=g)
    prefix, _ = M.forward(cfg, p, {"tokens": toks[:, :s]})
    dropped = []
    cache = M.init_cache(cfg, b, s + new, device=dev)
    last, _ = D.make_prefill_step(cfg, _moe_counter(dropped))(
        p, {"tokens": toks[:, :s]}, cache)
    check(bits_equal(last, prefix[:, -1]),
          f"{LM_ARCH} depth 2 fp32: prefill's last logits differ from the "
          f"full forward's at s-1")
    wide = dataclasses.replace(
        cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    no_drop = []
    err, _ = _decode_against_full(wide, p, toks, s, dev,
                                  f"{LM_ARCH} depth 2 fp32 (no drops)",
                                  moe_impl=_moe_counter(no_drop))
    check(int(sum(no_drop)) == 0, "capacity_factor E/k still drops")
    return dict(batch=b, prompt=s, new=new, prefill_bits_equal=True,
                capacity_factor=cfg.capacity_factor,
                prefill_dropped_pairs=int(sum(dropped)),
                pairs_routed=b * s * cfg.moe_top_k * cfg.n_layers,
                capacity_factor_no_drop=wide.capacity_factor,
                decode_err=err)


def lm_mamba_full(dev) -> dict:
    """mamba2-130m at full width, float32: a 300-token prompt (not a
    multiple of the 128 chunk) and 8 decode steps against the full
    forward."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models import params as Pm

    cfg = dataclasses.replace(registry.ARCHS["mamba2-130m"].config,
                              dtype="float32")
    g = torch.Generator(device=dev).manual_seed(3)
    p = Pm.init_params(cfg, g, torch.float32, dev)
    toks = torch.randint(0, cfg.vocab, (2, 308), device=dev, generator=g)
    err, _ = _decode_against_full(cfg, p, toks, 300, dev,
                                  "mamba2-130m full fp32")
    return dict(batch=2, prompt=300, new=8, decode_err=err)


def _lm_profile(fn, steps: int, untraced_ms: float, stem: str,
                out_dir: Path) -> dict:
    """``fn()`` (``steps`` prefill or decode steps) under torch.profiler:
    device time and device kernels a step, the busy share against the
    untraced ms a step, and the kernels that take the device time
    (``chiprun_out/profile_lm_<stem>.txt``)."""
    from torch.autograd import DeviceType

    (_, wall_s), events = traced(lambda: _sync_s(fn))
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    out = dict(device_ms=device_ms,
               kernels_a_step=sum(e.count for e in kernels) / steps,
               traced_ms=1e3 * wall_s / steps, untraced_ms=untraced_ms,
               busy_vs_untraced=device_ms / untraced_ms,
               top=[(e.key[:90], e.self_device_time_total / 1e3 / steps,
                     e.count / steps) for e in top])
    (out_dir / f"profile_lm_{stem}.txt").write_text(
        f"{stem}: device {device_ms:.3f} ms a step, "
        f"{out['kernels_a_step']:.0f} device kernels a step, untraced "
        f"{untraced_ms:.3f} ms a step, busy {out['busy_vs_untraced']:.3f}\n"
        + "\n".join(f"{ms:10.3f} ms {n:8.1f}x  {k}"
                     for k, ms, n in out["top"]) + "\n")
    return out


def _sync_s(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def lm_served(dev) -> dict:
    """qwen2-moe-a2.7b at full width and depth in bfloat16, weights drawn
    on the card: LM_REQUESTS prompts of LM_PROMPT tokens served greedy
    twice (bit-identical) and sampled twice from one seed (identical);
    the prefill's last logits equal the full forward's bit for bit, every
    logit finite; the prefill's dropped pairs; prefill ms and decode ms a
    token at LM_SWEEP batch sizes beside their bounds."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model as M, params as Pm
    from repro_torch.serve import decode as D

    cfg = registry.ARCHS[LM_ARCH].config
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device=dev).manual_seed(2)
    p, init_s = _sync_s(lambda: Pm.init_params(cfg, g, torch.bfloat16, dev))
    leaves = Pm.tree_leaves(p)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(sum(t.numel() for t in leaves) == cfg.num_params(),
          "the full tree is not num_params() elements")
    prompts = torch.randint(0, cfg.vocab, (LM_REQUESTS, LM_PROMPT),
                            device=dev, generator=g)

    greedy = [_sync_s(lambda: D.generate(cfg, p, prompts, LM_NEW))
              for _ in range(2)]
    check(torch.equal(greedy[0][0], greedy[1][0]),
          "served greedy runs differ")
    sampled = [_sync_s(lambda: D.generate(
        cfg, p, prompts, LM_NEW, temperature=0.8,
        generator=torch.Generator(device=dev).manual_seed(5)))
        for _ in range(2)]
    check(torch.equal(sampled[0][0], sampled[1][0]),
          "sampled runs from one seed differ")
    check(not torch.equal(sampled[0][0], greedy[0][0]),
          "sampling at 0.8 gave the greedy tokens")

    (full, _), full_s = _sync_s(lambda: M.forward(cfg, p,
                                                  {"tokens": prompts}))
    check(bool(torch.isfinite(full).all()), "full forward: a logit is not "
                                            "finite")
    dropped = []
    cache = M.init_cache(cfg, LM_REQUESTS, LM_PROMPT + LM_NEW, device=dev)
    last, _ = D.make_prefill_step(cfg, _moe_counter(dropped))(
        p, {"tokens": prompts}, cache)
    check(bits_equal(last, full[:, -1]), "bf16 prefill's last logits differ "
                                         "from the full forward's at s-1")
    del full
    prefill = D.make_prefill_step(cfg)
    _, prefill_s = _sync_s(lambda: prefill(p, {"tokens": prompts}, cache))

    d, hkv, hd = cfg.d_model, cfg.n_kv_heads, cfg.hd
    embed_bytes = cfg.vocab * d * 2
    tokens = LM_REQUESTS * LM_PROMPT
    flops = (2 * tokens * (cfg.active_params() - cfg.vocab * d)
             + 4 * LM_REQUESTS * cfg.n_heads * LM_PROMPT ** 2 * hd
             * cfg.n_layers)
    kv_bytes = lambda b, s: cfg.n_layers * 2 * b * s * hkv * hd * 2
    prefill_bound_ms = 1e3 * max(
        (param_bytes - embed_bytes + kv_bytes(LM_REQUESTS, LM_PROMPT))
        / HBM_BYTES_PER_S, flops / BF16_FLOP_S)

    step = D.make_decode_step(cfg)
    sweep = {}
    finite = torch.ones((), dtype=torch.bool, device=dev)
    for b in LM_SWEEP:
        pr = torch.randint(0, cfg.vocab, (b, LM_PROMPT), device=dev,
                           generator=g)
        s_max = LM_PROMPT + LM_SWEEP_STEPS + 1
        cache = M.init_cache(cfg, b, s_max, device=dev)
        last, cache = prefill(p, {"tokens": pr}, cache)
        finite &= torch.isfinite(last).all()
        tok = torch.argmax(last, -1)[:, None].int()
        tok, last, cache = step(p, cache, tok, LM_PROMPT)  # warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(1, LM_SWEEP_STEPS + 1):
            tok, last, cache = step(p, cache, tok, LM_PROMPT + i)
            finite &= torch.isfinite(last).all()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t) / LM_SWEEP_STEPS
        # a decode step reads every weight but the embedding (a gather of
        # b rows), and every slot of the KV cache
        step_bytes = (param_bytes - embed_bytes + b * d * 2
                      + kv_bytes(b, s_max))
        sweep[b] = dict(ms_per_token=ms, tokens_per_s=1e3 * b / ms,
                        bytes_read=step_bytes,
                        bound_ms=1e3 * step_bytes / HBM_BYTES_PER_S)
        del cache
    check(bool(finite), "a served logit is not finite")
    return dict(
        arch=LM_ARCH, params=cfg.num_params(), param_bytes=param_bytes,
        init_s=init_s, requests=LM_REQUESTS, prompt=LM_PROMPT, new=LM_NEW,
        greedy_walls_s=[w for _, w in greedy],
        sampled_walls_s=[w for _, w in sampled],
        served_tokens_per_s=LM_REQUESTS * LM_NEW / greedy[1][1],
        greedy_tokens=greedy[0][0].tolist(),
        sampled_tokens=sampled[0][0].tolist(),
        prefill_dropped_pairs=int(sum(dropped)),
        pairs_routed=tokens * cfg.moe_top_k * cfg.n_layers,
        full_forward_ms=1e3 * full_s, prefill_ms=1e3 * prefill_s,
        prefill_flops=flops, prefill_bound_ms=prefill_bound_ms,
        sweep=sweep, peak_bytes=torch.cuda.max_memory_allocated())


def lm_traced(dev, out_dir: Path) -> dict:
    """The served model's prefill (LM_REQUESTS x LM_PROMPT) and decode
    steps at the smallest and largest LM_SWEEP batch under torch.profiler:
    device time and device kernels a step against the untraced ms a step.
    It runs after phase 5's profiled runs: a profiler session early in
    the script left phase 5's traces without a device event (H100, torch
    2.11)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models import model as M, params as Pm
    from repro_torch.serve import decode as D

    cfg = registry.ARCHS[LM_ARCH].config
    torch.cuda.empty_cache()
    g = torch.Generator(device=dev).manual_seed(2)
    p = Pm.init_params(cfg, g, torch.bfloat16, dev)
    prefill, step = D.make_prefill_step(cfg), D.make_decode_step(cfg)
    out = {}
    for b in (LM_REQUESTS, LM_SWEEP[0], LM_SWEEP[-1]):
        prompts = torch.randint(0, cfg.vocab, (b, LM_PROMPT), device=dev,
                                generator=g)
        cache = M.init_cache(cfg, b, LM_PROMPT + 2 * LM_SWEEP_STEPS,
                             device=dev)
        if b == LM_REQUESTS:
            prefill(p, {"tokens": prompts}, cache)  # warm
            _, s_ = _sync_s(lambda: prefill(p, {"tokens": prompts}, cache))
            out["prefill"] = _lm_profile(
                lambda: prefill(p, {"tokens": prompts}, cache), 1, 1e3 * s_,
                "prefill", out_dir)
            continue
        last, cache = prefill(p, {"tokens": prompts}, cache)
        tok = torch.argmax(last, -1)[:, None].int()

        def steps(first, n, tok=tok):
            for i in range(first, first + n):
                tok, _, _ = step(p, cache, tok, LM_PROMPT + i)
        steps(0, 1)  # warm
        n = LM_SWEEP_STEPS // 2
        _, s_ = _sync_s(lambda: steps(1, n))
        out[f"decode_b{b}"] = _lm_profile(lambda: steps(1 + n, n), n,
                                          1e3 * s_ / n, f"decode_b{b}",
                                          out_dir)
        del cache
    del p
    torch.cuda.empty_cache()
    return out


def lm_traced_line(t: dict, smi: str) -> str:
    return (f"[5/5] {LM_ARCH} bf16 traced (device time and device kernels "
            f"a step; busy = device / untraced ms a step): " + "; ".join(
                f"{k} device {v['device_ms']:.2f} of {v['untraced_ms']:.2f} "
                f"ms (busy {v['busy_vs_untraced']:.2f}, "
                f"{v['kernels_a_step']:.0f} kernels; top "
                f"{v['top'][0][0][:40]} {v['top'][0][1]:.2f} ms)"
                for k, v in t.items()) + f" | {smi}")


def lm_phase(dev, smi: str, out_dir: Path) -> dict:
    """The LM serving path on the card (``repro_torch.models``,
    ``repro_torch.serve.decode``): the four parts above, each check
    raising; details in ``chiprun_out/lm_serve.json``. The path reaches
    none of the three kernels: their wrappers count no launch."""
    import torch

    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    on_device = ops.device_launch_counts()
    with torch.no_grad():
        smoke = lm_smoke_configs(dev)
        t1 = time.perf_counter()
        depth2 = lm_full_width_depth2(dev)
        torch.cuda.empty_cache()
        t2 = time.perf_counter()
        served = lm_served(dev)
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        mamba_full = lm_mamba_full(dev)
    torch.cuda.empty_cache()
    launches = ops.launch_counts()
    on_device = {k: v - on_device[k]
                 for k, v in ops.device_launch_counts().items()}
    check(not any(launches.values()) and not any(on_device.values()),
          f"the LM path launched a graph kernel: {launches}, on the "
          f"device {on_device}")
    out = dict(smi=smi, smoke=smoke, depth2=depth2, served=served,
               mamba_full=mamba_full, kernel_launches=launches,
               kernel_launches_on_device=on_device,
               seconds=dict(smoke=t1 - t0, depth2=t2 - t1, served=t3 - t2,
                            mamba=time.perf_counter() - t3,
                            total=time.perf_counter() - t0))
    (out_dir / "lm_serve.json").write_text(json.dumps(out, indent=1))
    return out


def lm_lines(d: dict) -> list:
    """The phase's printed lines, each with the card's name and power
    limit."""
    smi, sv, d2, mb = d["smi"], d["served"], d["depth2"], d["mamba_full"]
    sec = d["seconds"]
    smoke = "; ".join(f"{a} {r['card_vs_cpu_err']:.1e}/{r['decode_err']:.1e}"
                      for a, r in d["smoke"].items())
    sweep = "; ".join(
        f"batch {b}: {r['ms_per_token']:.2f} ms a token, "
        f"{r['tokens_per_s']:.1f} tokens/s (bound {r['bound_ms']:.2f} ms: "
        f"{r['bytes_read'] / 1e9:.2f} GB a step over 3.35 TB/s)"
        for b, r in sv["sweep"].items())
    return [
        f"[lm] ten smoke configs fp32 (max |card - CPU| within "
        f"{LM_CARD_TOL} / max |decode - full forward| within "
        f"{LM_DECODE_TOL}): {smoke}; greedy generate twice bit-identical "
        f"each ({sec['smoke']:.1f} s) | {smi}",
        f"[lm] {LM_ARCH} full width, depth 2, fp32: prefill's last "
        f"logits = full forward's at s-1 bit for bit ({d2['batch']}x"
        f"{d2['prompt']} tokens, {d2['prefill_dropped_pairs']} of "
        f"{d2['pairs_routed']} routed pairs dropped at capacity_factor "
        f"{d2['capacity_factor']:g}); at capacity_factor "
        f"{d2['capacity_factor_no_drop']:g} "
        f"{d2['new']} decode steps within {d2['decode_err']:.1e} of the "
        f"full forward ({sec['depth2']:.1f} s) | {smi}",
        f"[lm] {LM_ARCH} served, full width and depth, bf16, "
        f"{sv['params'] / 1e9:.2f} B params ({sv['param_bytes'] / 1e9:.2f} "
        f"GB) drawn on the card in {sv['init_s']:.2f} s: {sv['requests']} "
        f"requests x {sv['prompt']} prompt + {sv['new']} new tokens, greedy "
        f"twice bit-identical (walls {sv['greedy_walls_s'][0]:.2f} / "
        f"{sv['greedy_walls_s'][1]:.2f} s, {sv['served_tokens_per_s']:.1f} "
        f"new tokens/s), sampled at 0.8 twice identical (walls "
        f"{sv['sampled_walls_s'][0]:.2f} / {sv['sampled_walls_s'][1]:.2f} "
        f"s); prefill's last logits = full forward's bit for bit, every "
        f"logit finite; prefill dropped {sv['prefill_dropped_pairs']} of "
        f"{sv['pairs_routed']} routed (token, expert) pairs; prefill "
        f"{sv['prefill_ms']:.2f} ms (bound {sv['prefill_bound_ms']:.2f} ms, "
        f"{sv['prefill_flops'] / 1e12:.2f} TFLOP over 989 TFLOP/s), full "
        f"forward {sv['full_forward_ms']:.2f} ms; {sweep}; peak "
        f"{sv['peak_bytes'] / 2**30:.2f} GiB ({sec['served']:.1f} s) | {smi}",
        f"[lm] mamba2-130m full width fp32: {mb['prompt']}-token prompt "
        f"(chunk 128) + {mb['new']} decode steps within "
        f"{mb['decode_err']:.1e} of the full forward; graph kernels "
        f"launched by the LM path {d['kernel_launches']}; phase "
        f"{sec['total']:.1f} s | {smi}",
    ]


TRAIN_ARCH = "internvl2-2b"  # the largest single-card model with a prefix
TRAIN_BATCH, TRAIN_TOKENS = 8, 768  # + 256 patch embeddings: 8,192 positions
TRAIN_STEPS, TRAIN_MICRO = 8, 2
TRAIN_LOSS_TOL = 1e-5  # smoke: card loss and grad_norm against the CPU's
TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL = 1e-3, 1e-2  # of a leaf's largest |grad|
TRAIN_MB_ATOL = 2e-6  # microbatches 2 against 1: a 1e-5 first update
RESUME_ARCH = "mamba2-130m"


def _grads_of(cfg, params, batch):
    """The loss and every leaf's gradient (zeros where the loss does not
    reach a leaf), as the train step takes them."""
    import torch

    from repro_torch.models.params import tree_leaves
    from repro_torch.train import train_step as ts

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = ts.make_loss_fn(cfg, remat=True)(params, batch)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in leaves]
    for p in leaves:
        p.requires_grad_(False)
        p.grad = None
    return loss.detach(), grads


def _state_leaves(state):
    from repro_torch.models.params import tree_leaves

    return (tree_leaves(state.params) + tree_leaves(state.opt.m)
            + tree_leaves(state.opt.v) + [state.opt.step])


def _clone_state(state):
    from repro_torch.models.params import tree_map
    from repro_torch.train import train_step as ts

    return ts.TrainState(tree_map(lambda t: t.clone(), state.params),
                         state.opt._replace(
                             step=state.opt.step.clone(),
                             m=tree_map(lambda t: t.clone(), state.opt.m),
                             v=tree_map(lambda t: t.clone(), state.opt.v)))


def _checksums(tensors) -> list:
    """An exact checksum a tensor: the int64 sum of its 32-bit (16-bit)
    words, read with one sync."""
    import torch

    sums = []
    for t in tensors:
        word = {4: torch.int32, 2: torch.int16}[t.element_size()]
        sums.append(t.view(word).sum(dtype=torch.int64))
    return torch.stack(sums).tolist()


def train_smoke_configs(dev) -> dict:
    """The ten smoke configs in float32: the loss and gradients on the
    card against the CPU's from the same weights and batch; one step on
    the card twice from one state bit-identical (params, m, v, loss,
    grad_norm); its loss and grad_norm against the CPU's step; and
    microbatches=2 against 1 on the card."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import data, train_step as ts
    from repro_torch.train.optimizer import AdamW

    rows = {}
    for i, (arch, spec) in enumerate(registry.ARCHS.items()):
        cfg, opt = spec.smoke, AdamW(lr=1e-3)
        cpu = ts.init_train_state(cfg, opt, torch.Generator().manual_seed(i),
                                  device="cpu")
        card = ts.TrainState(tree_map(lambda t: t.to(dev), cpu.params),
                             opt.init(tree_map(lambda t: t.to(dev),
                                               cpu.params)))
        batch = data.SyntheticLM(cfg, 16, 4, seed=i, device="cpu").batch_at(0)
        cbatch = {k: v.to(dev) for k, v in batch.items()}
        l_cpu, g_cpu = _grads_of(cfg, cpu.params, batch)
        l_card, g_card = _grads_of(cfg, card.params, cbatch)
        check(abs(float(l_card) - float(l_cpu)) <= TRAIN_LOSS_TOL * abs(
            float(l_cpu)), f"{arch} smoke loss: card {float(l_card)} CPU "
                           f"{float(l_cpu)}")
        g_err = 0.0
        for a, w in zip(g_card, g_cpu):
            a, scale = a.cpu(), float(w.abs().max()) or 1.0
            err = (a - w).abs()
            check(bool((err <= TRAIN_GRAD_ATOL * scale
                        + TRAIN_GRAD_RTOL * w.abs()).all()),
                  f"{arch} smoke gradient: card against CPU off by "
                  f"{float(err.max())} of {scale}")
            g_err = max(g_err, float(err.max()) / scale)
        step = ts.make_train_step(cfg, opt, microbatches=1, remat=True)
        one, m1 = step(_clone_state(card), cbatch)
        two, m2 = step(_clone_state(card), cbatch)
        check(all(bits_equal(a, b) for a, b in zip(
            _state_leaves(one) + [m1["loss"], m1["grad_norm"]],
            _state_leaves(two) + [m2["loss"], m2["grad_norm"]])),
              f"{arch} smoke: one step twice from one state differs on the "
              f"card")
        _, mc = step(_clone_state(cpu), batch)
        for k in ("loss", "grad_norm"):
            check(abs(float(m1[k]) - float(mc[k])) <= TRAIN_LOSS_TOL * abs(
                float(mc[k])), f"{arch} smoke step {k}: card {float(m1[k])}"
                               f" CPU {float(mc[k])}")
        mb, mm = ts.make_train_step(cfg, opt, microbatches=2, remat=True)(
            _clone_state(card), cbatch)
        mb_err = max(float((a - b).abs().max()) for a, b in zip(
            tree_leaves(mb.params), tree_leaves(one.params)))
        check(mb_err <= TRAIN_MB_ATOL and abs(
            float(mm["loss"]) - float(m1["loss"])) <= TRAIN_LOSS_TOL * abs(
            float(m1["loss"])), f"{arch} smoke: microbatches 2 against 1 "
                                f"off by {mb_err} (loss {float(mm['loss'])} "
                                f"against {float(m1['loss'])})")
        rows[arch] = dict(loss=float(m1["loss"]),
                          grad_norm=float(m1["grad_norm"]),
                          loss_cpu=float(mc["loss"]), grad_rel_err=g_err,
                          microbatch_err=mb_err)
    return rows


def _train_flop_bound(cfg, params) -> dict:
    """6 x matmul params x positions, plus the attention's 4 s^2 d a layer
    and sequence, times 3 (forward and backward), over 989 TFLOP/s."""
    blocks = params["blocks"]
    mat = sum(t.numel() for lp in blocks.values() for t in lp.values()
              if t.ndim == 3)
    mat += params["lm_head"].numel() if "lm_head" in params else \
        params["embed"].numel()
    s = TRAIN_TOKENS + cfg.frontend_tokens
    flops = (6 * mat * TRAIN_BATCH * s
             + 3 * 4 * s * s * cfg.d_model * cfg.n_layers * TRAIN_BATCH)
    return dict(matmul_params=mat, flops=flops,
                bound_ms=1e3 * flops / BF16_FLOP_S)


def train_full_width(dev) -> dict:
    """TRAIN_ARCH at full width and depth: float32 master weights and
    AdamW state, bf16 compute, remat, TRAIN_MICRO microbatches, a global
    batch of TRAIN_BATCH x (256 patch embeddings + TRAIN_TOKENS tokens)
    for TRAIN_STEPS steps. Step 0 runs twice from one seeded init and the
    two states' checksums are equal; every loss and grad_norm finite; the
    parameters moved."""
    import math

    import torch

    from repro_torch.configs import registry
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import data, train_step as ts
    from repro_torch.train.optimizer import AdamW

    cfg, opt = registry.ARCHS[TRAIN_ARCH].config, AdamW()
    pipe = data.SyntheticLM(cfg, TRAIN_TOKENS, TRAIN_BATCH, device=dev)
    step = ts.make_train_step(cfg, opt, microbatches=TRAIN_MICRO, remat=True)

    def fresh():
        gen = torch.Generator(device=dev).manual_seed(0)
        return ts.init_train_state(cfg, opt, gen, device=dev)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state, init_s = _sync_s(fresh)
    n = sum(t.numel() for t in tree_leaves(state.params))
    check(n == cfg.num_params(), "the train state is not num_params()")
    bound = _train_flop_bound(cfg, state.params)
    before = _checksums(tree_leaves(state.params))
    batch0 = pipe.batch_at(0)
    sums, metrics, walls = [], [], []
    for rep in range(2):
        if rep:
            del state
            torch.cuda.empty_cache()
            state = fresh()
        (state, m), wall = _sync_s(lambda: step(state, batch0))
        sums.append(_checksums(_state_leaves(state)))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(wall)
    check(sums[0] == sums[1] and metrics[0] == metrics[1],
          f"{TRAIN_ARCH}: step 0 twice from one seeded init differs")
    after = sums[1][:len(before)]
    moved = sum(a != b for a, b in zip(after, before))
    check(moved == len(before), f"{TRAIN_ARCH}: {len(before) - moved} "
                                f"parameter leaves did not move")
    for i in range(1, TRAIN_STEPS):
        batch = pipe.batch_at(i)
        (state, m), wall = _sync_s(lambda: step(state, batch))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(wall)
    check(all(math.isfinite(x) for pair in metrics for x in pair),
          f"{TRAIN_ARCH}: a loss or grad_norm is not finite: {metrics}")
    peak = torch.cuda.max_memory_allocated()
    del state
    torch.cuda.empty_cache()
    ms = 1e3 * float(sorted(walls[2:])[len(walls[2:]) // 2])
    positions = TRAIN_BATCH * (TRAIN_TOKENS + cfg.frontend_tokens)
    state_bytes = 16 * n
    # one entry a step (step 0's second run stands for it)
    return dict(params=n, state_bytes=state_bytes, init_s=init_s,
                losses=[x for x, _ in metrics[1:]],
                grad_norms=[x for _, x in metrics[1:]],
                step0_walls_s=walls[:2], walls_s=walls, median_ms=ms,
                positions_per_s=positions / (ms / 1e3),
                tokens_per_s=TRAIN_BATCH * TRAIN_TOKENS / (ms / 1e3),
                positions=positions,
                peak_bytes=peak, step0_checksums_equal=True,
                leaves_moved=moved, **bound)


def train_moe_depth2(dev) -> dict:
    """qwen2-moe-a2.7b at full width, depth 2, float32 (the LM phase's
    depth-2 weights): one train step twice from one seeded state, bit-identical
    (checksums of params, m, v; loss and grad_norm): the MoE combine's
    backward at full width."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import data, train_step as ts
    from repro_torch.train.optimizer import AdamW

    cfg = dataclasses.replace(registry.ARCHS[LM_ARCH].config, n_layers=2,
                              dtype="float32")
    opt = AdamW()
    batch = data.SyntheticLM(cfg, 64, 4, seed=1, device=dev).batch_at(0)
    step = ts.make_train_step(cfg, opt, microbatches=1, remat=True)
    sums, metrics, walls = [], [], []
    for _ in range(2):
        torch.cuda.empty_cache()
        gen = torch.Generator(device=dev).manual_seed(1)
        state = ts.init_train_state(cfg, opt, gen, device=dev)
        (state, m), wall = _sync_s(lambda: step(state, batch))
        sums.append(_checksums(_state_leaves(state)))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        walls.append(wall)
        n = sum(t.numel() for t in tree_leaves(state.params))
        del state
    torch.cuda.empty_cache()
    check(sums[0] == sums[1] and metrics[0] == metrics[1],
          f"{LM_ARCH} depth 2 fp32: one train step twice differs")
    return dict(params=n, loss=metrics[0][0], grad_norm=metrics[0][1],
                walls_s=walls, batch=4, tokens=64)


def train_resume(dev, tmp: Path, out_dir: Path) -> dict:
    """``launch.train.main`` in this process on RESUME_ARCH at full width
    (4 x 128 tokens a step): 12 steps with a checkpoint every 5, then 20
    steps on the same directory (it resumes from step 11's checkpoint),
    against a straight 20-step run: the two final checkpoints equal
    array for array, bit for bit. The runs' own saves and restore are
    timed as they happen (an async save's time is its device-to-host
    copy; the blocking final saves and the restore are whole)."""
    import contextlib
    import io

    import numpy as np
    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.train import checkpoint as ckpt

    argv = ["--arch", RESUME_ARCH, "--seq-len", "128", "--global-batch", "4",
            "--save-every", "5", "--log-every", "100", "--seed", "0"]
    a, b = tmp / "resumed", tmp / "straight"
    times = {"async save": [], "blocking save": [], "restore": []}
    real = ckpt.save, ckpt.restore

    def save(*args, blocking=True, **kw):
        t = time.perf_counter()
        out = real[0](*args, blocking=blocking, **kw)
        times["blocking save" if blocking else "async save"].append(
            1e3 * (time.perf_counter() - t))
        return out

    def restore(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real[1](*args, **kw)
        torch.cuda.synchronize()
        times["restore"].append(1e3 * (time.perf_counter() - t))
        return out

    log = io.StringIO()
    t0 = time.perf_counter()
    ckpt.save, ckpt.restore = save, restore
    try:
        with contextlib.redirect_stdout(log):
            for steps, d in ((12, a), (20, a), (20, b)):
                check(launch_train.main(argv + ["--steps", str(steps),
                                                "--ckpt-dir", str(d)]) == 0,
                      f"launch.train --steps {steps} failed")
    finally:
        ckpt.save, ckpt.restore = real
    run_s = time.perf_counter() - t0
    (out_dir / "train_resume.log").write_text(log.getvalue())
    check("resumed from step 12" in log.getvalue(),
          "the second launch did not resume from step 12")
    last = 19
    files = [d / f"step_{last:08d}" for d in (a, b)]
    za, zb = (np.load(f / "shard_0.npz") for f in files)

    def same(x, y):
        return x.dtype == y.dtype and x.shape == y.shape and np.array_equal(
            x.reshape(-1).view(np.uint8), y.reshape(-1).view(np.uint8))
    check(sorted(za.files) == sorted(zb.files)
          and all(same(za[k], zb[k]) for k in za.files),
          "the resumed run's final checkpoint differs from the straight "
          "run's")
    check((files[0] / "manifest.json").read_text()
          == (files[1] / "manifest.json").read_text(), "manifests differ")
    torch.cuda.empty_cache()
    return dict(arrays=len(za.files), run_s=run_s, times_ms=times,
                bytes=(files[1] / "shard_0.npz").stat().st_size,
                steps=(12, 20))


def train_phase(dev, smi: str, out_dir: Path) -> dict:
    """LM training on the card (``repro_torch.train``, ``launch.train``,
    ``train_lm``): the parts above, each check raising; ``python -m
    repro_torch.train_lm --steps 10`` as a subprocess beside the smoke
    configs' checks, whose times no line reads, and ended before the
    timed parts, which then have the card to themselves. The phase
    launches none of the three graph kernels."""
    import os

    import torch

    from repro_torch.kernels import build, ops

    t0 = time.perf_counter()
    ops.reset_launch_counts()
    on_device = ops.device_launch_counts()
    tmp = tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    example = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.train_lm", "--steps", "10",
         "--ckpt-dir", str(Path(tmp.name) / "train_lm")], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        smoke = train_smoke_configs(dev)
        t1 = time.perf_counter()
        example_out, _ = example.communicate(timeout=300)
    finally:
        if example.poll() is None:
            example.kill()
            example.wait()
    (out_dir / "train_lm.log").write_text(example_out)
    check(example.returncode == 0, f"python -m repro_torch.train_lm exit "
                                   f"{example.returncode}")
    t2 = time.perf_counter()
    full = train_full_width(dev)
    t3 = time.perf_counter()
    moe = train_moe_depth2(dev)
    t4 = time.perf_counter()
    resume = train_resume(dev, Path(tmp.name), out_dir)
    t5 = time.perf_counter()
    tmp.cleanup()
    launches = ops.launch_counts()
    on_device = {k: v - on_device[k]
                 for k, v in ops.device_launch_counts().items()}
    check(not any(launches.values()) and not any(on_device.values()),
          f"the training path launched a graph kernel: {launches}, on the "
          f"device {on_device}")
    out = dict(smi=smi, smoke=smoke, full=full, moe=moe, resume=resume,
               train_lm_tail=example_out.splitlines()[-1:],
               kernel_launches=launches, kernel_launches_on_device=on_device,
               seconds=dict(smoke=t1 - t0, example_wait=t2 - t1,
                            full=t3 - t2, moe=t4 - t3, resume=t5 - t4,
                            total=time.perf_counter() - t0))
    (out_dir / "train.json").write_text(json.dumps(out, indent=1))
    return out


def train_lines(d: dict) -> list:
    """The phase's printed lines, each with the card's name and power
    limit."""
    smi, f, mo, r, sec = (d["smi"], d["full"], d["moe"], d["resume"],
                          d["seconds"])
    smoke = "; ".join(f"{a} loss {v['loss']:.4f} grad {v['grad_rel_err']:.1e}"
                      f" mb {v['microbatch_err']:.1e}"
                      for a, v in d["smoke"].items())
    return [
        f"[train] ten smoke configs fp32, card against CPU (loss and "
        f"grad_norm within rtol {TRAIN_LOSS_TOL}, every gradient within "
        f"{TRAIN_GRAD_ATOL} x its leaf's largest + rtol {TRAIN_GRAD_RTOL}; "
        f"largest gradient error over leaf scale shown), one step twice "
        f"from one state bit-identical each, microbatches 2 against 1 "
        f"within {TRAIN_MB_ATOL} (largest shown): {smoke} "
        f"({sec['smoke']:.1f} s, beside python -m repro_torch.train_lm "
        f"--steps 10, exit 0, waited {sec['example_wait']:.1f} s more) | "
        f"{smi}",
        f"[train] {TRAIN_ARCH} full width and depth, {f['params'] / 1e9:.3f} "
        f"B params, fp32 master + AdamW ({f['state_bytes'] / 1e9:.1f} GB), "
        f"bf16 compute, remat, microbatches {TRAIN_MICRO}, {TRAIN_BATCH} x "
        f"(256 patches + {TRAIN_TOKENS} tokens) = {f['positions']} "
        f"positions a step, {TRAIN_STEPS} steps: init {f['init_s']:.2f} s; "
        f"step 0 twice from one seeded init, every checksum equal, all "
        f"{f['leaves_moved']} parameter leaves moved; losses "
        + ", ".join(f"{x:.4f}" for x in f["losses"])
        + f", grad_norms " + ", ".join(f"{x:.3f}" for x in f["grad_norms"])
        + f" (all finite); median {f['median_ms']:.1f} ms a step (steps "
        f"1-{TRAIN_STEPS - 1}), {f['positions_per_s']:.0f} positions/s "
        f"({f['tokens_per_s']:.0f} tokens/s, the {TRAIN_BATCH} x "
        f"{TRAIN_TOKENS} tokens alone); bound "
        f"{f['bound_ms']:.1f} ms ({f['flops'] / 1e12:.1f} TFLOP: 6 x "
        f"{f['matmul_params'] / 1e9:.3f} B matmul params x {f['positions']}"
        f" + attention, over 989 TFLOP/s bf16); peak "
        f"{f['peak_bytes'] / 2**30:.2f} GiB ({sec['full']:.1f} s) | {smi}",
        f"[train] {LM_ARCH} full width, depth 2, fp32, {mo['params'] / 1e9:.3f}"
        f" B params: one step ({mo['batch']} x {mo['tokens']} tokens) twice "
        f"from one seeded state bit-identical (loss {mo['loss']:.4f}, "
        f"grad_norm {mo['grad_norm']:.3f}; walls "
        f"{mo['walls_s'][0]:.2f} / {mo['walls_s'][1]:.2f} s) "
        f"({sec['moe']:.1f} s) | {smi}",
        f"[train] {RESUME_ARCH} full width through launch.train.main: "
        f"{r['steps'][0]} steps with --save-every 5, then --steps "
        f"{r['steps'][1]} on the same directory (resumed from step 12) = a "
        f"straight {r['steps'][1]}-step run, all {r['arrays']} arrays of "
        f"the final checkpoint bit for bit ({r['run_s']:.1f} s for the "
        f"three runs, the card to themselves); checkpoints of "
        f"{r['bytes'] / 1e9:.2f} GB: "
        + "; ".join(f"{k} " + "/".join(f"{x:.0f}" for x in v) + " ms"
                    for k, v in r["times_ms"].items())
        + f"; graph kernels launched by the training path "
        f"{d['kernel_launches']}; phase {sec['total']:.1f} s | {smi}",
    ]


def train_traced(dev, out_dir: Path, untraced_ms: float) -> dict:
    """One TRAIN_ARCH train step (after a warm one) under torch.profiler:
    device time and device kernels against the untraced median ms a step.
    It runs after phase 5's profiled runs, as :func:`lm_traced` does."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.train import data, train_step as ts
    from repro_torch.train.optimizer import AdamW

    cfg, opt = registry.ARCHS[TRAIN_ARCH].config, AdamW()
    torch.cuda.empty_cache()
    state = ts.init_train_state(
        cfg, opt, torch.Generator(device=dev).manual_seed(0), device=dev)
    step = ts.make_train_step(cfg, opt, microbatches=TRAIN_MICRO, remat=True)
    pipe = data.SyntheticLM(cfg, TRAIN_TOKENS, TRAIN_BATCH, device=dev)
    state, _ = step(state, pipe.batch_at(0))
    batch = pipe.batch_at(1)
    out = _lm_profile(lambda: step(state, batch), 1, untraced_ms,
                      "train_step", out_dir)
    del state
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import os

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no port package under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    from repro_torch import paper_tables
    from repro_torch.algorithms import REGISTRY, common, get_program
    from repro_torch.algorithms.common import pj_converge
    from repro_torch.core import combiners as cb
    from repro_torch.core import compose
    from repro_torch.core import routing
    from repro_torch.graph import generators as gen, oracles, pgraph
    from repro_torch.kernels import build, ops, ref as kref
    from repro_torch.pregel.engine import Engine

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    detail = {}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    # the planner's probe cache: a temporary directory, so every run
    # probes the card afresh and leaves nothing behind
    build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    plan_cache = tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent)
    os.environ["REPRO_TORCH_PLAN_CACHE"] = str(Path(plan_cache.name) / "smoke")

    # -- 1. environment and build ------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    t = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t
    regs = [ln.strip() for log in logs.values() for ln in log.splitlines()
            if "registers" in ln]
    detail["env"] = dict(device=name, nvidia_smi=smi, torch=torch.__version__,
                         cuda=torch.version.cuda, build_s=build_s,
                         ptxas=regs)
    print(f"[1/5] env: {name} | {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | kernels built in {build_s:.1f} s "
          f"({len(logs)} nvcc)", flush=True)

    # -- the LM serving path, on a card that holds nothing else yet --------
    detail["lm"] = lm_phase(dev, smi, out_dir)
    for line in lm_lines(detail["lm"]):
        print(line, flush=True)

    # -- LM training, on a card that holds nothing else yet either --------
    detail["train"] = train_phase(dev, smi, out_dir)
    for line in train_lines(detail["train"]):
        print(line, flush=True)

    # -- 2. kernels against their plain versions on the card ----------------
    t = time.perf_counter()
    pr_graph = REGISTRY["pagerank:scatter"].make_graph(FULL_SCALE, 0)
    pr_pg = pgraph.partition_graph(pr_graph, W, "random",
                                   build=REGISTRY["pagerank:scatter"].build)
    pr_host_s = time.perf_counter() - t
    plan = pr_pg.scatter_out
    # the wcc:basic partition: its recipe and plans are the S-V ones, so
    # sv:composed, sv:basic and wcc:switch run on it too
    t_w = time.perf_counter()
    wcc_spec = REGISTRY["wcc:basic"]
    check(all(REGISTRY[k].make_graph is wcc_spec.make_graph
              and REGISTRY[k].build == wcc_spec.build
              for k in ("sv:composed", "sv:basic", "wcc:switch")),
          "the S-V programs no longer share wcc:basic's recipe and plans")
    wcc_graph = wcc_spec.make_graph(FULL_SCALE, 0)
    wcc_pg = pgraph.partition_graph(wcc_graph, W, "random",
                                    build=wcc_spec.build)
    wcc_host_s = time.perf_counter() - t_w
    sv_plan = wcc_pg.scatter_out
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {}

    # the batched plane's union route keys at scale 20: the owners of the
    # union of every edge destination (u_cap = min(Q * e_cap, W * n_loc),
    # as the union CombinedMessage sizes it), half of the Q lanes member
    # of each real entry, none of a sentinel entry
    raw = pr_pg.raw_out
    n_total = W * pr_pg.n_loc
    union_cap = min(NQ * raw.e_cap, n_total)
    u_dst, _ = routing.dedup_dense(raw.dst_global, raw.mask, n_total,
                                   union_cap)
    lkeys = torch.where(u_dst != routing.BIG, u_dst // pr_pg.n_loc,
                        W).to(torch.int32)
    lanes = ((torch.rand((W, union_cap, NQ), device=dev, generator=g)
              < 0.5) & (lkeys < W)[..., None])
    bucket_cases = bucket_edge_cases(dev, g, lkeys)
    errs["bucket_ranks"] = errs["bucket_ranks_lanes"] = 0.0

    def seg_case(vals, seg, n, comb, rtol=0.0, atol=0.0, what=""):
        """Kernel against plain: exact (NaN where the plain version has
        NaN) unless a tolerance is given; the max |error| of a float sum."""
        out = ops.segment_combine(vals, seg, n, comb)
        want = kref.segment_combine_ref(vals, seg, n, comb)
        torch.testing.assert_close(
            out, want, rtol=rtol, atol=atol, equal_nan=True,
            msg=lambda m: f"segment_combine {what} {comb}: {m}")
        if rtol == 0.0 and atol == 0.0:
            return 0.0
        return float((out - want).abs().max())

    e_cap, u_cap = plan.e_cap, plan.u_cap
    recv_n = W * plan.slot_cap
    f32 = torch.rand((W, e_cap, 1), device=dev, generator=g)
    i32 = torch.randint(-1000, 1000, (W, e_cap, 1), device=dev,
                        dtype=torch.int32, generator=g)
    # f32 sum: sums of up to a hub's in-degree of U[0, 1) values in another
    # order than index_add's atomics — reassociation only
    e1 = seg_case(f32, plan.edge_seg, u_cap, "sum", 1e-4, 1e-5, "send f32")
    rv = torch.rand((W, recv_n, 1), device=dev, generator=g)
    e2 = seg_case(rv, plan.recv_sorted, pr_pg.n_loc, "sum", 1e-4, 1e-5,
                  "recv f32")
    for comb in ("min", "max"):
        seg_case(f32, plan.edge_seg, u_cap, comb, what="send f32")
    seg_case(i32, plan.edge_seg, u_cap, "sum", what="send i32")
    inf = float("inf")
    probe_v = torch.tensor([[inf], [inf], [5.0], [inf], [2.0], [inf]],
                           device=dev)
    probe_s = torch.tensor([0, 0, 1, 2, 2, 3], device=dev, dtype=torch.int32)
    got = ops.segment_combine(probe_v, probe_s, 4, "min")
    check(torch.equal(got[:, 0], torch.tensor([inf, 5.0, 2.0, inf],
                                              device=dev)),
          f"fault-1 probe: min gave {got[:, 0].tolist()}")
    for comb in ("sum", "max"):
        seg_case(probe_v, probe_s, 4, comb, what="fault-1 probe")
    empty_s = torch.tensor([1, 1, 4, 7, 9], device=dev, dtype=torch.int32)
    for vals in (torch.tensor([[1.5], [2.0], [-3.0], [4.0], [5.0]],
                              device=dev),
                 torch.tensor([[3], [-2], [7], [1], [1]], device=dev,
                              dtype=torch.int32)):
        for comb in ("sum", "min", "max"):
            seg_case(vals, empty_s, 6, comb, what="empty/dropped")
    seg_case(torch.tensor([True, False, False, True, True], device=dev),
             empty_s, 6, "or", what="empty/dropped bool")
    edge = segment_edge_cases(plan, g, seg_case)
    sv_cases = sv_min_cases(sv_plan, wcc_pg.n_loc, g, seg_case)
    prop_plan = wcc_pg.prop_out
    prop_cases = prop_min_cases(prop_plan, wcc_pg.n_loc, g, seg_case)
    # two runs of pagerank's send side: bit-identical (no float atomics)
    send_a = ops.segment_combine(f32, plan.edge_seg, u_cap, "sum")
    send_b = ops.segment_combine(f32, plan.edge_seg, u_cap, "sum")
    check(torch.equal(send_a, send_b),
          "segment_combine send side differs between two runs")
    torch.cuda.synchronize()
    errs["segment_combine"] = max(e1, e2, edge["max_abs_err"])
    detail["kernel_checks"] = dict(errs, pagerank_host_setup_s=pr_host_s,
                                   wcc_host_setup_s=wcc_host_s,
                                   bucket_cases=bucket_cases,
                                   sv_int32_min_cases=sv_cases,
                                   prop_min_cases=prop_cases)
    print(f"[2/5] kernels vs plain on the card: bucket_ranks ({W}, 2^21) "
          f"and bucket_ranks_lanes ({W}, {union_cap}, {NQ}) exact on "
          f"{len(bucket_cases)} cases (random, sorted, one hub bucket, all "
          f"sentinel, out of range; the lanes kernel also on the main "
          f"path's union keys); "
          f"segment_combine at the pagerank plan (W={W}, "
          f"e_cap={e_cap}, u_cap={u_cap}, recv {recv_n}) f32 sum max|err| "
          f"{errs['segment_combine']:.3g} (rtol 1e-4, atol 1e-5), min/max/"
          f"int32 sum exact, fault-1 probe [inf,5,2,inf], empty segments "
          f"hold the identity; {edge['cases']} edge cases at ({W}, {e_cap}) "
          f"(a 2^20-entry hub, all dropped, N=1, tile-edge gaps, half-row "
          f"tail, D=1/3/5, NaN/inf, int32 wrap) exact but for random f32 "
          f"sums; send side bit-identical in two runs; int32 min at the "
          f"S-V plan (send ({W}, {sv_plan.e_cap}) into {sv_plan.u_cap}, "
          f"recv {tuple(sv_plan.recv_sorted.shape)} into {wcc_pg.n_loc}) "
          f"exact on {len(sv_cases)} cases (ids, INT32_MAX/MIN, one hub, "
          f"all dropped); the Propagation channel's min at the wcc:prop "
          f"plan (int_dst ({W}, {prop_plan.ei_cap}) into {wcc_pg.n_loc}, "
          f"cut send ({W}, {prop_plan.cut.e_cap}) into "
          f"{prop_plan.cut.u_cap}, cut recv "
          f"{tuple(prop_plan.cut.recv_sorted.shape)}) exact on "
          f"{len(prop_cases)} cases (int32 as above, float32 with +inf) "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    # the rest of the paper's table: msf's min_by_first candidate combine
    # and pagerank:basic's float32 sums as their first superstep hands them
    # to the order-sensitive dispatch (captured from a one-superstep run),
    # and prod on the pagerank plan
    t = time.perf_counter()
    eng = Engine(mode="host")
    msf_spec = REGISTRY["msf:channels"]
    check(REGISTRY["msf:monolithic"].make_graph is msf_spec.make_graph,
          "the MSF variants no longer share one recipe")
    msf_graph = msf_spec.make_graph(FULL_SCALE, 0)
    msf_pg = pgraph.partition_graph(msf_graph, W, "random",
                                    build=msf_spec.build)
    msf_host_s = time.perf_counter() - t
    msf_calls = captured_reduces(lambda: eng.run(
        get_program("msf:channels"), msf_pg, max_steps=1))
    pr_calls = captured_reduces(lambda: eng.run(
        get_program("pagerank:basic", iters=30), pr_pg, max_steps=1))
    check(len(msf_calls) == 2 and len(pr_calls) == 2
          and all(c[3].name == "min_by_first" for c in msf_calls)
          and all(c[3].name == "sum" for c in pr_calls),
          "the first supersteps of msf:channels and pagerank:basic no "
          "longer make two order-sensitive combines each")
    by_first = by_first_cases(msf_calls, g)
    prod = prod_cases(plan, pr_pg.n_loc, g, seg_case)
    # the contributions are pr / deg, about 1e-7 an edge and 1e-6 a
    # vertex's sum: the tolerance is relative, with an atol far below
    # any nonzero sum
    sum_err = sum_rel = 0.0
    for side, (v, ids, n, comb) in zip(("send", "recv"), pr_calls):
        a = ops.segment_reduce(v, ids, n, comb)
        b = ops.segment_reduce(v, ids, n, comb)
        check(bits_equal(a, b), f"pagerank:basic float32 sum, {side} side: "
              "two runs through the dispatch differ")
        want = comb.segment_reduce(v, ids, n)
        torch.testing.assert_close(
            a, want, rtol=1e-4, atol=1e-12,
            msg=lambda m: f"pagerank:basic float32 sum {side}: {m}")
        sum_err = max(sum_err, float((a - want).abs().max()))
        nz = want != 0
        sum_rel = max(sum_rel, float(((a - want)[nz] / want[nz]).abs()
                                     .max()))
    torch.cuda.synchronize()
    errs["min_by_first"] = 0.0
    errs["combined_sum"] = sum_err
    detail["kernel_checks"].update(
        min_by_first=by_first, prod_cases=prod, msf_host_setup_s=msf_host_s,
        pagerank_basic_sum=dict(
            max_abs_err=sum_err, max_rel_err=sum_rel,
            shapes=[list(c[0].shape) for c in pr_calls],
            segments=[c[2] for c in pr_calls]))
    print(f"[2/5] the new ops on the card: min_by_first bit-exact against "
          f"plain at the scale-{FULL_SCALE} msf plan on "
          f"{len(by_first['cases'])} cases (send {by_first['send_shape']} "
          f"into {by_first['send_segments']}: the first superstep's "
          f"candidates, D=1/3/5, int32, a hub of tied keys won by the last, "
          f"NaN/+-inf/-0.0 keys, all dropped; recv "
          f"{by_first['recv_shape']} into {by_first['recv_segments']} "
          f"through the dispatch, two runs bit-identical); prod exact for "
          f"int32 and powers of two, rtol 1e-4 near 1, on {len(prod)} "
          f"cases; pagerank:basic's float32 sums through the dispatch "
          f"(stable sort + kernel; {[list(c[0].shape) for c in pr_calls]}) "
          f"two runs bit-identical, max|err| {sum_err:.3g}, max relative "
          f"{sum_rel:.3g} against plain (rtol 1e-4, atol 1e-12) (msf graph "
          f"set-up {msf_host_s:.1f} s; "
          f"{time.perf_counter() - t:.1f} s)", flush=True)

    # the kernels inside a captured CUDA graph (what the fused and chunked
    # modes replay): each capture replayed on fresh inputs, exact; and
    # bucket_ranks across the end of its epoch lap
    t = time.perf_counter()
    whiles = while_node_check(dev)
    replays = replay_checks(dev, g, lkeys, sv_plan, wcc_pg.n_loc,
                            msf_calls[1])
    wrap = epoch_wrap_check(dev, g)
    detail["kernel_checks"].update(while_nodes=whiles,
                                   captured_replays=replays, epoch_wrap=wrap)
    print(f"[2/5] WHILE nodes in one captured graph (inside an IF, inside "
          f"a WHILE inside an IF, zero trips; {whiles['depths']} body "
          f"depths), every replay counting exactly: "
          + ", ".join(f"trips {r['trips']} IF {r['if_taken']} -> "
                      f"{r['counts']}" for r in whiles["replays"])
          + "; the kernels in a captured CUDA graph, each replay on fresh "
          f"inputs exact against plain: {', '.join(replays)} (bucket_ranks "
          f"({W}, 2^21) random/sorted/one bucket/reversed, the lanes kernel "
          f"at {tuple(lkeys.shape)} x {NQ} lanes, int32 min at the S-V "
          f"receiver {tuple(sv_plan.recv_sorted.shape)} into "
          f"{wcc_pg.n_loc}, min_by_first at msf's receiver "
          f"{tuple(msf_calls[1][0].shape)} into {msf_calls[1][2]}, both with "
          f"a run of empty segments that moves each replay); bucket_ranks "
          f"across the epoch limit {wrap['limit']}: stored epochs "
          f"{wrap['stored_epochs']}, every call exact, the "
          f"{wrap['status_words']} status words zeroed at the limit, and "
          f"the same four launches inside a WHILE node exact, epoch "
          f"{wrap['in_a_while']['stored_epoch']} after "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    t = time.perf_counter()
    detail["fault11"] = fault11_cases(dev, g)
    print(fault11_line(detail["fault11"])
          + f" ({time.perf_counter() - t:.1f} s)", flush=True)

    # -- 3. reference counts at scale 12 ------------------------------------
    t = time.perf_counter()
    refs = {
        "wcc:basic": (gen.rmat(12, edge_factor=8, seed=2).symmetrized(), {},
                      (6, 42027, 336216)),
        "pagerank:scatter": (gen.rmat(12, edge_factor=12, seed=1,
                                      directed=True), {"iters": 10},
                             (10, 98130, 392520)),
    }
    counts = {}
    for key, (graph, knobs, want) in refs.items():
        pg = pgraph.partition_graph(graph, W, "random",
                                    build=REGISTRY[key].build)
        res = eng.run(get_program(key, **knobs), pg)
        got = (res.steps, res.total_msgs, res.total_bytes)
        check(got == want, f"{key} scale-12 counts {got} != {want}")
        counts[key] = dict(steps=got[0], msgs=got[1], bytes=got[2],
                           bytes_by_channel=res.bytes_by_channel)
    # the batched plane: Q=32 queries of the registry recipe, W=8 (the
    # JAX package's host-mode run_batch gives these counts); and
    # pagerank:personal solo from source 0
    t_b = time.perf_counter()
    for key, want in PERSONAL_REFS.items():
        spec = REGISTRY[key]
        graph = spec.make_graph(12, 0)
        pg = pgraph.partition_graph(graph, W, "random", build=spec.build)
        res = eng.run(spec.factory(source=0), pg)
        got = (res.steps, res.total_msgs, res.total_bytes,
               res.bytes_by_channel)
        check(got == want, f"{key} scale-12 counts {got} != {want}")
        spec.check(graph, pg, res, {"source": 0})
        counts[key] = dict(steps=got[0], msgs=got[1], bytes=got[2],
                           bytes_by_channel=got[3])
    for key, want in BATCH_REFS.items():
        spec = REGISTRY[key]
        graph = spec.make_graph(12, 0)
        pg = pgraph.partition_graph(graph, W, "random", build=spec.build)
        queries = spec.queries(graph, 0, NQ)
        res = eng.run_batch(spec.factory(**spec.inputs(graph, 0)), pg,
                            queries)
        got = (res.steps, res.total_msgs, res.total_bytes)
        check(got == want, f"{key} scale-12 batched counts {got} != {want}")
        check(res.num_pad_lanes == 0, f"{key}: {res.num_pad_lanes} pad lanes")
        for qi, query in enumerate(queries):
            solo = eng.run(spec.factory(**{spec.query_knob: query}), pg)
            check(same_run(lane_of(res, qi), solo_of(solo)),
                  f"{key} scale-12 lane {qi} differs from its solo run")
        if key in BATCH_INFO_REFS:
            info = res.state["info"]
            got_info = (info[0, :, 0].tolist(),
                        info[:, :, 1].sum(dim=0).tolist())
            check(bool((info[..., 0] == info[:1, :, 0]).all())
                  and got_info == BATCH_INFO_REFS[key],
                  f"{key} scale-12 batched info {got_info} != "
                  f"{BATCH_INFO_REFS[key]}")
        counts[f"{key} batched"] = dict(
            steps=got[0], msgs=got[1], bytes=got[2], queries=NQ,
            query_steps=res.query_steps.tolist())
    batch3_s = time.perf_counter() - t_b
    # the composition layer's programs: every count and every channel's
    # bytes exact, each oracle, the S-V variants' labels identical
    t_s = time.perf_counter()
    social = refs["wcc:basic"][0]
    social_pg = pgraph.partition_graph(social, W, "random",
                                       build=REGISTRY["sv:composed"].build)
    pj_spec = REGISTRY["pj:basic"]
    forest = pj_spec.make_graph(12, 0)
    forest_in = pj_spec.inputs(forest, 0)
    forest_pg = pgraph.partition_graph(forest, W, "random",
                                       build=pj_spec.build)
    sv_labels = {}
    for key, want in SV_REFS.items():
        spec = REGISTRY[key]
        graph, pg, inputs = (
            (forest, forest_pg, forest_in) if key.startswith("pj:")
            else (social, social_pg, {}))
        res = eng.run(spec.factory(**inputs), pg)
        got = (res.steps, res.total_msgs, res.total_bytes,
               res.bytes_by_channel)
        check(got == want, f"{key} scale-12 counts {got} != {want}")
        check(res.halted, f"{key} scale-12 did not halt")
        spec.check(graph, pg, res, inputs)
        if key.startswith("sv:"):
            sv_labels[key] = res.output
        counts[key] = dict(steps=got[0], msgs=got[1], bytes=got[2],
                           bytes_by_channel=res.bytes_by_channel)
    for key, labels in sv_labels.items():
        check(np.array_equal(labels, sv_labels["sv:basic"]),
              f"{key} labels differ from sv:basic's at scale 12")
    composed, basic = counts["sv:composed"], counts["sv:basic"]
    check(composed["steps"] < basic["steps"]
          and composed["bytes"] < basic["bytes"],
          "sv:composed does not beat sv:basic on supersteps and bytes at "
          "scale 12")
    sv3_s = time.perf_counter() - t_s
    # the rest of the paper's table: pagerank:basic on the table's web
    # dataset, both MSF variants on its weighted instance, then the port's
    # whole paper table (python -m repro_torch.paper_tables --scale 12)
    t_n = time.perf_counter()
    new_graphs = {"web": paper_tables.dataset("web", 12),
                  "weighted": paper_tables.dataset("weighted", 10)}
    for key, want in NEW_REFS.items():
        spec = REGISTRY[key]
        graph = new_graphs["weighted" if key.startswith("msf") else "web"]
        knobs = {"iters": 10} if key == "pagerank:basic" else {}
        pg = pgraph.partition_graph(graph, W, "random", build=spec.build)
        res = eng.run(get_program(key, **knobs), pg)
        got = (res.steps, res.total_msgs, res.total_bytes,
               res.bytes_by_channel)
        check(got == want, f"{key} scale-12 counts {got} != {want}")
        spec.check(graph, pg, res, {})
        counts[key] = dict(steps=got[0], msgs=got[1], bytes=got[2],
                           bytes_by_channel=res.bytes_by_channel)
        if key.startswith("msf"):
            out = res.output
            check(out["edges"] == MSF_REF_EDGES
                  and abs(out["weight"] - MSF_REF_WEIGHT) < 1e-3,
                  f"{key} scale-12 forest {out['weight']} / {out['edges']} "
                  f"edges != {MSF_REF_WEIGHT} / {MSF_REF_EDGES}")
            counts[key].update(weight=out["weight"], edges=out["edges"])
    try:
        table12 = paper_tables.run_and_write(
            12, str(out_dir / "paper_tables_torch_12.json"))
    except SystemExit as err:
        raise SmokeFailure(f"paper table at scale 12: {err}") from None
    rows12 = [(r["variant"], r["supersteps"], r["messages"], r["bytes"])
              for r in table12["rows"]]
    check(rows12 == [tuple(r) for r in PAPER_REFS],
          f"paper table at scale 12: rows {rows12} != {PAPER_REFS}")
    new3_s = time.perf_counter() - t_n
    # the Propagation programs: every count, every channel's bytes and the
    # per-worker rounds and iterations exact, each oracle; scipy's strong
    # components (the scale-20 ground truth below) held to scc_oracle
    t_p = time.perf_counter()
    for key, want in PROP_REFS.items():
        spec = REGISTRY[key]
        graph = spec.make_graph(12, 0)
        pg = pgraph.partition_graph(graph, W, "random", build=spec.build)
        inputs = spec.inputs(graph, 0)
        res = eng.run(spec.factory(**inputs), pg)
        got = (res.steps, res.total_msgs, res.total_bytes,
               res.bytes_by_channel, res.state[PROP_COUNTER[key]].tolist())
        check(got == want, f"{key} scale-12 counts {got} != {want}")
        check(res.halted, f"{key} scale-12 did not halt")
        spec.check(graph, pg, res, inputs)
        counts[key] = dict(steps=got[0], msgs=got[1], bytes=got[2],
                           bytes_by_channel=got[3], counter=got[4])
    scc12 = REGISTRY["scc:prop"].make_graph(12, 0)
    check(np.array_equal(canon(strong_components(scc12)),
                         canon(oracles.scc_oracle(scc12))),
          "scipy's strong components differ from scc_oracle at scale 12")
    prop3_s = time.perf_counter() - t_p
    # the planner: Engine(mode="host", plan="auto") held to the JAX
    # package's planned counts, on the kernels at the default threshold
    t_pl = time.perf_counter()
    for key, want in PLAN_REFS.items():
        spec = REGISTRY[key]
        graph = spec.make_graph(12, 0)
        pg = pgraph.partition_graph(graph, W, "random", build=spec.build)
        inputs = spec.inputs(graph, 0)
        res = Engine(mode="host", plan="auto").run(spec.factory(**inputs),
                                                   pg)
        got = (res.steps, res.total_msgs, res.total_bytes,
               res.bytes_by_channel)
        check(got == want, f"{key} scale-12 planned counts {got} != {want}")
        check((res.plan.use_kernel, res.plan.route_impl,
               res.plan.dense_threshold) == (True, "bucket", 0.1),
              f"{key} scale-12 plan {res.plan.knobs()}")
        spec.check(graph, pg, res, inputs)
        counts[f"{key} planned"] = dict(
            steps=got[0], msgs=got[1], bytes=got[2], bytes_by_channel=got[3],
            dense_threshold=res.plan.dense_threshold)
    plan3_s = time.perf_counter() - t_pl
    detail["reference_counts"] = dict(counts, batched_part_s=batch3_s,
                                      composition_part_s=sv3_s,
                                      paper_table_part_s=new3_s,
                                      propagation_part_s=prop3_s,
                                      planned_part_s=plan3_s,
                                      paper_table_12=table12)
    print(f"[3/5] scale-12 reference counts exact: " + "; ".join(
        f"{k} {v['steps']}/{v['msgs']}/{v['bytes']}"
        for k, v in counts.items()) +
        f"; all {NQ} lanes of each batched run bit-identical to their solo "
        f"runs; bytes of every channel of the {len(SV_REFS)} composition-"
        f"layer programs exact, their oracles ok, the six S-V variants' "
        f"labels identical, sv:composed ahead of sv:basic "
        f"({composed['steps']} vs {basic['steps']} supersteps, "
        f"{composed['bytes']} vs {basic['bytes']} bytes) "
        f"; the port's paper table at scale 12: all {len(rows12)} rows' "
        f"supersteps, messages and bytes equal the reference's, headline "
        f"held; msf edges {MSF_REF_EDGES}; the {len(PROP_REFS)} "
        f"Propagation programs' bytes per channel and per-worker rounds/"
        f"iterations exact, their oracles ok, scipy's strong components = "
        f"scc_oracle; Engine(plan=\"auto\") of {', '.join(PLAN_REFS)} "
        f"= the JAX planned counts, on the kernels at threshold 0.1 "
        f"({time.perf_counter() - t:.1f} s, batched part "
        f"{batch3_s:.1f} s, composition part {sv3_s:.1f} s, paper-table "
        f"part {new3_s:.1f} s, propagation part {prop3_s:.1f} s, planned "
        f"part {plan3_s:.1f} s)", flush=True)

    # -- 4. the main path at full size --------------------------------------
    t = time.perf_counter()
    pr_prog = get_program("pagerank:scatter", iters=30)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    wcc_res, wcc_ms = timed(lambda: eng.run(get_program("wcc:basic"), wcc_pg))
    pr_res, pr_ms = timed(lambda: eng.run(pr_prog, pr_pg))
    launches = ops.launch_counts()
    check(launches["bucket_ranks"] > 0, "wcc:basic never launched bucket_ranks")
    check(launches["segment_combine"] > 0,
          "pagerank:scatter never launched segment_combine")
    pr_again = eng.run(pr_prog, pr_pg)
    check(torch.equal(pr_res.state["pr"], pr_again.state["pr"]),
          "pagerank:scatter ranks differ between two runs on the card")
    t_or = time.perf_counter()
    # the components' ground truth, computed once: wcc:basic, sv:composed,
    # sv:basic and wcc:switch are held to it
    truth = canon(gen.components_ground_truth(wcc_graph))
    check(np.array_equal(canon(wcc_res.output), truth),
          "wcc:basic labels differ from the ground truth")
    REGISTRY["pagerank:scatter"].check(pr_graph, pr_pg, pr_res)
    oracle_s = time.perf_counter() - t_or
    main = {}
    for key, res, pg in (("wcc:basic", wcc_res, wcc_pg),
                         ("pagerank:scatter", pr_res, pr_pg)):
        ms = [1e3 * s for s in res.step_times_s]
        main[key] = dict(n=pg.n, edges=int(
            (wcc_graph if key == "wcc:basic" else pr_graph).num_edges),
            steps=res.steps, halted=res.halted, msgs=res.total_msgs,
            bytes=res.total_bytes, bytes_by_channel=res.bytes_by_channel,
            step_ms=ms, loop_wall_s=res.wall_time_s,
            run_wall_ms=wcc_ms if key == "wcc:basic" else pr_ms,
            route_cap=pg.route_cap)
    detail["main_path"] = dict(main, launches=launches,
                               wcc_host_setup_s=wcc_host_s, oracle_s=oracle_s)

    def fmt_ms(ms):
        return ",".join(f"{x:.2f}" for x in ms)

    print(f"[4/5] main path scale {FULL_SCALE}, W={W}: wcc:basic n="
          f"{wcc_pg.n} {main['wcc:basic']['edges']} edges, "
          f"{wcc_res.steps} steps, {wcc_res.total_bytes} bytes, oracle ok, "
          f"step ms [{fmt_ms(main['wcc:basic']['step_ms'])}]; "
          f"pagerank:scatter {main['pagerank:scatter']['edges']} edges, "
          f"{pr_res.steps} steps, oracle ok (rtol 1e-4, atol 1e-7), two runs "
          f"bit-identical, step ms [{fmt_ms(main['pagerank:scatter']['step_ms'])}]"
          f"; launches {launches} ({time.perf_counter() - t:.1f} s)",
          flush=True)

    # the composed S-V program at full size against the unoptimized one,
    # both on the wcc:basic partition; the inner rounds of the composed
    # program's jump loop are counted through a wrapper of pj_converge
    t = time.perf_counter()
    jump_rounds = []

    def counted_pj_converge(*args, **kw):
        out = pj_converge(*args, **kw)
        jump_rounds.append(out[1])
        return out

    sv_runs = {}
    for key in ("sv:composed", "sv:basic"):
        prog = get_program(key)
        torch.cuda.synchronize()
        base_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        common.pj_converge = counted_pj_converge
        try:
            res, ms = timed(lambda: eng.run(prog, wcc_pg))
        finally:
            common.pj_converge = pj_converge
        sv_runs[key] = dict(
            res=res, run_wall_ms=ms, launches=ops.launch_counts(),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            base_gib=base_gib)
    sv_launches = sv_runs["sv:composed"]["launches"]
    check(sv_launches["bucket_ranks"] > 0,
          "sv:composed never launched bucket_ranks")
    check(sv_launches["segment_combine"] > 0,
          "sv:composed never launched segment_combine")
    check(len(jump_rounds) == sv_runs["sv:composed"]["res"].steps,
          f"sv:composed ran its jump loop {len(jump_rounds)} times")
    t_or = time.perf_counter()
    for key, run in sv_runs.items():
        res = run["res"]
        check(res.halted and np.array_equal(canon(res.output), truth),
              f"{key} at scale {FULL_SCALE} differs from the ground truth")
    sv_oracle_s = time.perf_counter() - t_or
    composed, basic = sv_runs["sv:composed"]["res"], sv_runs["sv:basic"]["res"]
    check(composed.steps < basic.steps
          and composed.total_bytes < basic.total_bytes,
          f"sv:composed ({composed.steps} supersteps, {composed.total_bytes} "
          f"bytes) does not beat sv:basic ({basic.steps}, "
          f"{basic.total_bytes}) at scale {FULL_SCALE}")
    sv_main = {}
    for key, run in sv_runs.items():
        res = run.pop("res")
        sv_main[key] = dict(
            run, steps=res.steps, msgs=res.total_msgs, bytes=res.total_bytes,
            bytes_by_channel=res.bytes_by_channel,
            bytes_by_group=compose.group_stats(res.bytes_by_channel),
            step_ms=[1e3 * x for x in res.step_times_s],
            loop_wall_s=res.wall_time_s)
    sv_main["sv:composed"]["jump_rounds"] = jump_rounds
    wall_ratio = (sv_main["sv:basic"]["run_wall_ms"]
                  / sv_main["sv:composed"]["run_wall_ms"])

    # wcc:switch on the same partition: wcc:basic's labels and supersteps;
    # pj:reqresp on the scale-20 forest
    sw_res, sw_ms = timed(lambda: eng.run(get_program("wcc:switch"), wcc_pg))
    check(np.array_equal(sw_res.output, wcc_res.output)
          and sw_res.steps == wcc_res.steps,
          "wcc:switch differs from wcc:basic at full size")
    check(np.array_equal(canon(sw_res.output), truth),
          "wcc:switch differs from the ground truth")
    pj_forest = pj_spec.make_graph(FULL_SCALE, 0)
    pj_in = pj_spec.inputs(pj_forest, 0)
    pj_pg = pgraph.partition_graph(pj_forest, W, "random",
                                   build=pj_spec.build)
    pj_res, pj_ms = timed(lambda: eng.run(
        REGISTRY["pj:reqresp"].factory(**pj_in), pj_pg))
    REGISTRY["pj:reqresp"].check(pj_forest, pj_pg, pj_res, pj_in)
    sv_main["wcc:switch"] = dict(
        steps=sw_res.steps, bytes=sw_res.total_bytes,
        bytes_by_channel=sw_res.bytes_by_channel, run_wall_ms=sw_ms,
        step_ms=[1e3 * x for x in sw_res.step_times_s])
    sv_main["pj:reqresp"] = dict(
        n=pj_pg.n, steps=pj_res.steps, bytes=pj_res.total_bytes,
        bytes_by_channel=pj_res.bytes_by_channel, run_wall_ms=pj_ms,
        step_ms=[1e3 * x for x in pj_res.step_times_s])
    detail["sv_path"] = dict(sv_main, composed_launches=sv_launches,
                             wall_ratio_basic_over_composed=wall_ratio,
                             oracle_s=sv_oracle_s,
                             phase_s=time.perf_counter() - t)

    def sv_row(key):
        v = sv_main[key]
        return (f"{key} {v['steps']} steps, {v['bytes']} bytes "
                f"{v['bytes_by_channel']}, step ms [{fmt_ms(v['step_ms'])}], "
                f"run {v['run_wall_ms']:.1f} ms, peak {v['peak_gib']:.2f} GiB "
                f"({v['base_gib']:.2f} before the run)")

    print(f"[4/5] composed S-V scale {FULL_SCALE}, W={W}: "
          f"{sv_row('sv:composed')}, jump rounds a superstep {jump_rounds}; "
          f"{sv_row('sv:basic')}; both oracle ok; sv:composed ahead on "
          f"supersteps and bytes, wall time sv:basic/sv:composed "
          f"{wall_ratio:.2f}x; launches in sv:composed {sv_launches}; "
          f"wcc:switch {sw_res.steps} steps, {sw_res.total_bytes} bytes "
          f"{sw_res.bytes_by_channel}, labels = wcc:basic's, run "
          f"{sw_ms:.1f} ms; pj:reqresp on the {pj_pg.n}-vertex forest "
          f"{pj_res.steps} steps, {pj_res.total_bytes} bytes, oracle ok, run "
          f"{pj_ms:.1f} ms ({time.perf_counter() - t:.1f} s)", flush=True)

    # the rest of the paper's table at full size: pagerank:basic on the
    # pagerank:scatter graph (run twice: bit-identical), both MSF variants
    # on the registry's weighted symmetrised R-MAT; each path with its own
    # launch counts (reset just before it, read just after)
    t = time.perf_counter()

    def run_path(prog, pg):
        torch.cuda.synchronize()
        base_gib = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        res, ms = timed(lambda: eng.run(prog, pg))
        return dict(res=res, run_wall_ms=ms, launches=ops.launch_counts(),
                    peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                    base_gib=base_gib)

    prb_prog = get_program("pagerank:basic", iters=30)
    new_runs = {"pagerank:basic": run_path(prb_prog, pr_pg)}
    for key in ("msf:channels", "msf:monolithic"):
        new_runs[key] = run_path(get_program(key), msf_pg)
    for key, run in new_runs.items():
        check(run["launches"]["bucket_ranks"] > 0
              and run["launches"]["segment_combine"] > 0,
              f"{key} did not launch both main-path kernels: "
              f"{run['launches']}")
    prb_res = new_runs["pagerank:basic"]["res"]
    prb_again = eng.run(prb_prog, pr_pg)
    check(bits_equal(prb_res.state["pr"], prb_again.state["pr"]),
          "pagerank:basic ranks differ between two runs on the card")
    t_or = time.perf_counter()
    REGISTRY["pagerank:basic"].check(pr_graph, pr_pg, prb_res)
    prb_oracle_s = time.perf_counter() - t_or
    vs_scatter = np.abs(prb_res.output - pr_res.output)
    vs_scatter_rel = vs_scatter / np.maximum(np.abs(pr_res.output), 1e-30)
    t_or = time.perf_counter()
    msf_truth = gen.components_ground_truth(msf_graph)
    msf_comps = len(np.unique(msf_truth))
    msf_truth_canon = canon(msf_truth)
    truth_s = time.perf_counter() - t_or
    t_or = time.perf_counter()
    msf_w_oracle = oracles.msf_weight_oracle(msf_graph)
    kruskal_s = time.perf_counter() - t_or
    msf_bound = 1e-2 + 1e-5 * msf_w_oracle
    # Boruvka assumes unique weights; float32 weights collide at this size
    # (scripts/msf_weight_ties.py counts the same at other scales)
    und = msf_graph.edges[:, 0] < msf_graph.edges[:, 1]
    _, wcounts = np.unique(msf_graph.weights[und], return_counts=True)
    msf_ties = dict(undirected_edges=int(und.sum()),
                    shared_values=int((wcounts > 1).sum()),
                    edges_sharing=int(wcounts[wcounts > 1].sum()))
    for key in ("msf:channels", "msf:monolithic"):
        out = new_runs[key]["res"].output
        check(new_runs[key]["res"].halted,
              f"{key} at scale {FULL_SCALE} did not halt")
        check(out["edges"] == msf_graph.n - msf_comps,
              f"{key}: {out['edges']} forest edges, want "
              f"{msf_graph.n - msf_comps}")
        check(np.array_equal(canon(out["labels"]), msf_truth_canon),
              f"{key} labels differ from the components' ground truth")
        check(abs(out["weight"] - msf_w_oracle) <= msf_bound,
              f"{key} forest weight {out['weight']} vs Kruskal "
              f"{msf_w_oracle}: off by more than {msf_bound}")
    msf_c, msf_m = (new_runs[k]["res"] for k in ("msf:channels",
                                                 "msf:monolithic"))
    check(msf_c.total_bytes < msf_m.total_bytes,
          f"msf:channels ({msf_c.total_bytes} bytes) does not beat "
          f"msf:monolithic ({msf_m.total_bytes}) at scale {FULL_SCALE}")
    new_main = {}
    for key, run in new_runs.items():
        res = run.pop("res")
        graph = pr_graph if key == "pagerank:basic" else msf_graph
        new_main[key] = dict(
            run, n=graph.n, edges=int(graph.num_edges), steps=res.steps,
            halted=res.halted, msgs=res.total_msgs, bytes=res.total_bytes,
            bytes_by_channel=res.bytes_by_channel,
            step_ms=[1e3 * x for x in res.step_times_s],
            ms_per_superstep=run["run_wall_ms"] / max(res.steps, 1),
            loop_wall_s=res.wall_time_s)
        if key.startswith("msf"):
            new_main[key].update(weight=res.output["weight"],
                                 forest_edges=res.output["edges"])
    detail["new_programs"] = dict(
        new_main, pagerank_basic_vs_scatter=dict(
            max_abs=float(vs_scatter.max()),
            max_rel=float(vs_scatter_rel.max())),
        msf_weight_oracle=msf_w_oracle, msf_weight_bound=msf_bound,
        msf_weight_ties=msf_ties,
        msf_components=msf_comps, pagerank_oracle_s=prb_oracle_s,
        components_truth_s=truth_s, kruskal_s=kruskal_s,
        phase_s=time.perf_counter() - t)

    def new_row(key):
        v = new_main[key]
        extra = (f", forest {v['weight']:.4f} with {v['forest_edges']} edges"
                 if key.startswith("msf") else "")
        return (f"{key} {v['steps']} steps, {v['bytes']} bytes{extra}, "
                f"{v['ms_per_superstep']:.2f} ms a superstep, run "
                f"{v['run_wall_ms']:.1f} ms, peak {v['peak_gib']:.2f} GiB "
                f"({v['base_gib']:.2f} before), launches {v['launches']}")

    print(f"[4/5] the rest of the paper's table at scale {FULL_SCALE}, "
          f"W={W}: {new_row('pagerank:basic')}; two runs bit-identical, "
          f"oracle ok (rtol 1e-4, atol 1e-7), against pagerank:scatter's "
          f"ranks max |diff| {vs_scatter.max():.3g}, max rel "
          f"{vs_scatter_rel.max():.3g} (not gated); msf on "
          f"{msf_graph.n} vertices, {msf_graph.num_edges} directed edges: "
          f"{new_row('msf:channels')}; {new_row('msf:monolithic')}; both "
          f"{msf_graph.n - msf_comps} edges = n - #components, labels = "
          f"the ground truth, |weight - {msf_w_oracle:.4f}| <= "
          f"{msf_bound:.4f} ({msf_ties['shared_values']} weight values "
          f"shared among {msf_ties['undirected_edges']} undirected edges); "
          f"msf:channels below msf:monolithic in bytes "
          f"(ground truth {truth_s:.1f} s, Kruskal {kruskal_s:.1f} s; "
          f"{time.perf_counter() - t:.1f} s)", flush=True)

    # the port's paper table at full size (python -m repro_torch.paper_tables
    # --scale 20): host mode, headline held
    t = time.perf_counter()
    try:
        table20 = paper_tables.run_and_write(
            FULL_SCALE, str(out_dir / "paper_tables_torch.json"))
    except SystemExit as err:
        raise SmokeFailure(f"paper table at scale {FULL_SCALE}: {err}") \
            from None
    detail["paper_table"] = table20
    check(all(r["fused"] is not None for r in table20["rows"]),
          "a row of the paper table has no fused entry")

    def fused_col(r):
        f = r["fused"]
        return (f"fused {1e3 * f['wall_time_s']:.1f} ms/"
                f"{f['ms_per_superstep']:.2f} ms a superstep/"
                f"{f['dispatches']} dispatch/capture "
                f"{f['compile_time_s']:.2f} s")

    print(f"[4/5] paper table at scale {FULL_SCALE} (host mode, and the "
          f"fused column): " + "; ".join(
        f"{r['algorithm']} {r['program']} {r['variant']} "
        f"{r['supersteps']}/{r['bytes']} B/{r['ms_per_superstep']:.2f} ms a "
        f"superstep/run {1e3 * r['wall_time_s']:.1f} ms/peak "
        f"{r['peak_gib']:.2f} GiB/launches bucket_ranks "
        f"{r['launches']['bucket_ranks']}, segment_combine "
        f"{r['launches']['segment_combine']}; {fused_col(r)}"
        for r in table20["rows"]) +
        f"; headline held ({table20['headline']['round_reduction']:.2f}x "
        f"rounds, {table20['headline']['traffic_reduction']:.2f}x bytes) "
        f"({time.perf_counter() - t:.1f} s)", flush=True)

    # the batched query plane at full size: Q=32 sources per program.
    # reach's recipe graph is pagerank's (_directed_rmat), so its
    # partition is reused; sssp has its own weighted graph
    t = time.perf_counter()
    check(REGISTRY["reach:basic"].make_graph is
          REGISTRY["pagerank:scatter"].make_graph,
          "reach:basic no longer shares pagerank's recipe graph")
    sssp_spec = REGISTRY["sssp:basic"]
    sssp_graph = sssp_spec.make_graph(FULL_SCALE, 0)
    sssp_pg = pgraph.partition_graph(sssp_graph, W, "random",
                                     build=sssp_spec.build)
    batch_host_s = time.perf_counter() - t
    batch_jobs = {"reach:basic": (pr_graph, pr_pg),
                  "sssp:basic": (sssp_graph, sssp_pg)}
    runs = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    for key, (graph, pg) in batch_jobs.items():
        spec = REGISTRY[key]
        queries = spec.queries(graph, 0, NQ)
        prog = spec.factory()
        res, ms = timed(lambda: eng.run_batch(prog, pg, queries))
        runs[key] = (queries, prog, res, ms)
    b_launches = ops.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(b_launches["bucket_ranks_lanes"] > 0,
          "the batched runs never launched bucket_ranks_lanes")
    batched, solos = {}, {}
    for key, (queries, prog, res, ms) in runs.items():
        spec = REGISTRY[key]
        graph, pg = batch_jobs[key]
        # every lane against its solo run (the serial baseline of the
        # queries/s comparison); the host oracles on the two lanes with
        # the most supersteps (ties: lower lane)
        oracle_lanes = sorted(range(NQ), key=lambda qi: (
            -res.query_steps[qi], qi))[:2]
        solo_ms = []
        for qi, source in enumerate(queries):
            solo, s_ms = timed(lambda: eng.run(spec.factory(source=source),
                                               pg))
            solo_ms.append(s_ms)
            solos.setdefault(key, []).append(solo_of(solo))
            check(same_run(lane_of(res, qi), solo_of(solo)),
                  f"{key} scale-{FULL_SCALE} lane {qi} differs from its "
                  "solo run")
            if qi in oracle_lanes:
                spec.check(graph, pg, solo, {"source": source})
        batched[key] = dict(
            n=pg.n, edges=int(graph.num_edges), e_cap=pg.raw_out.e_cap,
            route_cap=pg.route_cap, steps=res.steps,
            query_steps=res.query_steps.tolist(), msgs=res.total_msgs,
            bytes=res.total_bytes, run_wall_ms=ms,
            step_ms=[1e3 * x for x in res.step_times_s],
            batched_qps=NQ / (ms / 1e3), solo_ms=solo_ms,
            solo_qps=NQ / (sum(solo_ms) / 1e3), oracle_lanes=oracle_lanes)
    batch4_s = time.perf_counter() - t
    detail["batched_path"] = dict(batched, launches=b_launches,
                                  peak_gib=peak_gib,
                                  sssp_host_setup_s=batch_host_s,
                                  phase_s=batch4_s)
    rows = "; ".join(
        f"{k} {v['steps']} steps (lanes {min(v['query_steps'])}-"
        f"{max(v['query_steps'])}), {v['bytes']} bytes, run "
        f"{v['run_wall_ms']:.1f} ms = {v['batched_qps']:.1f} q/s batched vs "
        f"{v['solo_qps']:.1f} q/s solo ({NQ} solo runs, "
        f"{sum(v['solo_ms']):.1f} ms; every lane bit-identical to its solo "
        f"run, oracle ok on lanes {v['oracle_lanes']})"
        for k, v in batched.items())
    print(f"[4/5] batched plane scale {FULL_SCALE}, W={W}, Q={NQ}: {rows}; "
          f"launches {b_launches}; peak device memory {peak_gib:.2f} GiB "
          f"({batch4_s:.1f} s, {batch_host_s:.1f} s of it sssp graph set-up)",
          flush=True)

    # the batched plane in the device modes and the serving substrate, on
    # the same partitions and sources: run_batch in host, fused, chunked
    # K=64 and K=4 (bit-identical, launches equal, a batch with 12 pad
    # lanes replaying the fused loop), then Engine.serve of the same Q=32
    # sources as a Poisson stream through 8 lanes at serve chunks 4 and 64
    # (every query equal to its solo run above, a warm second session, a
    # quarantined query isolated)
    t = time.perf_counter()
    batch_modes, serving = {}, {}
    for key, (queries, prog, _, _) in runs.items():
        graph, pg = batch_jobs[key]
        batch_modes[key], _ = batch_mode_runs(prog, pg, queries)
        serving[key] = serve_runs(REGISTRY[key], prog, pg, graph,
                                  solos[key])
    plane_s = time.perf_counter() - t
    detail["batched_device_modes"] = dict(batch_modes, phase_s=plane_s)
    detail["serving"] = serving

    def batch_row(key):
        v = batch_modes[key]
        return (f"{key} {v['host']['steps']} steps: " + ", ".join(
            f"{m} {v[m]['run_wall_ms']:.1f} ms (loop "
            f"{v[m]['loop_wall_ms']:.1f}, {v[m]['qps']:.1f} q/s, "
            f"{v[m]['dispatches']} dispatches, "
            f"{v[m]['overhead_ms_per_step']:.3f} ms host overhead a step, "
            f"capture {v[m]['capture_s']:.2f} s, peak "
            f"{v[m]['peak_gib']:.2f} GiB)" for m in ("host", *MODE_RUNS))
            + "; bucket_ranks_lanes launches on the device in each mode "
            f"{v['host']['launches_on_device']['bucket_ranks_lanes']}")

    def serve_row(key):
        v = serving[key]
        return f"{key}: " + ", ".join(
            f"chunk {c}: {x['qps']:.1f} q/s, latency p50 / p99 "
            f"{x['p50_steps']:.0f} / {x['p99_steps']:.0f} supersteps = "
            f"{x['p50_ms']:.1f} / {x['p99_ms']:.1f} ms, median dispatch "
            f"{x['median_dispatch_ms']:.2f} ms, {x['dispatches']} dispatches "
            f"of {x['supersteps']} supersteps, capture {x['capture_s']:.2f} "
            f"s, peak {x['peak_gib']:.2f} GiB, bucket_ranks_lanes "
            f"{x['launches_on_device']['bucket_ranks_lanes']} on the device"
            for c, x in ((c, v[f"chunk{c}"]) for c in SERVE_CHUNKS)) + (
            f"; query {v['quarantine']['qid']} quarantined, the rest equal "
            "to their solo runs")

    print(f"[4/5] the batched plane in the device modes, scale {FULL_SCALE}, "
          f"W={W}, Q={NQ} (ms: Engine.run_batch; loop: the superstep loop "
          "alone), every run bit-identical to host mode, launches equal, a "
          f"Q={NQ - 12} batch replaying the fused loop with 12 pad lanes: "
          + "; ".join(batch_row(k) for k in runs), flush=True)
    print(f"[4/5] Engine.serve, {NQ} queries a Poisson stream of one a "
          f"superstep through {SERVE_LANES} lanes, two sessions a chunk (the "
          "second a replay, reported), every query equal to its solo host "
          "run: " + "; ".join(serve_row(k) for k in runs)
          + f" ({plane_s:.1f} s)", flush=True)

    # pagerank:personal (the static channels under the batched plane:
    # every segment_combine launch on Q·D columns) and batched pj:reqresp
    # (the union RequestRespond, a new call site of bucket_ranks_lanes):
    # personal solo from source 0 in every mode, then Q=32 queries of each
    # solo, batched in every mode and served; then the lane route (one
    # route pass a lane) against the union route at Q=32, fused
    t = time.perf_counter()
    pp_spec, pjr_spec = REGISTRY["pagerank:personal"], REGISTRY["pj:reqresp"]
    check(pp_spec.make_graph is REGISTRY["pagerank:scatter"].make_graph
          and set(pp_spec.build) <= set(REGISTRY["pagerank:scatter"].build),
          "pagerank:personal no longer shares pagerank's recipe and plans")
    pp_prog0 = pp_spec.factory(source=0)
    pp_solo, pp_fused = mode_runs(pp_prog0, pr_pg)
    pp_res = pp_fused.run(pp_prog0, pr_pg)
    pp_spec.check(pr_graph, pr_pg, pp_res, {"source": 0})
    pp_fused.clear_cache()
    personal, pp_prog, pp_queries, _ = batched_program_runs(
        pp_spec, pr_graph, pr_pg, "segment_combine",
        (("segment_combine", 2),), "fused")
    pjb, pj_prog, pj_queries, pj_host = batched_program_runs(
        pjr_spec, pj_forest, pj_pg, "bucket_ranks_lanes",
        (("bucket_ranks_lanes", 1),), "host")
    # the kernels' inputs on these paths, for phase 5: pagerank:personal's
    # send and receive combines and _request_union's route pass, as the
    # first batched superstep hands them over
    pp_calls = captured_calls(ops, "segment_combine", lambda: Engine(
        mode="host").run_batch(pp_prog, pr_pg, pp_queries, max_steps=1))
    check(len(pp_calls) == 2 and all(
        c[0][0].shape[-1] == NQ for c in pp_calls),
        f"pagerank:personal's batched step made {len(pp_calls)} "
        "segment_combine calls, not 2 on Q columns")
    pj_calls = captured_calls(routing, "union_ranks", lambda: Engine(
        mode="host").run_batch(pj_prog, pj_pg, pj_queries, max_steps=1))
    check(len(pj_calls) == 1, f"pj:reqresp's batched step made "
          f"{len(pj_calls)} union route passes, not 1")
    lane = {key: lane_baseline(runs[key][1], batch_jobs[key][1],
                               runs[key][0], runs[key][2],
                               batch_modes[key]["fused"])
            for key in ("reach:basic", "sssp:basic")}
    lane["pj:reqresp"] = lane_baseline(pj_prog, pj_pg, pj_queries, pj_host,
                                       pjb["modes"]["fused"])
    slice_s = time.perf_counter() - t
    detail["personal_and_reqresp"] = dict(
        personal_solo=pp_solo, personal=personal, pj_reqresp=pjb,
        lane_baseline=lane, phase_s=slice_s)

    def new_row(key, v):
        return (f"{key} ({v['steps']} steps, lanes {min(v['query_steps'])}-"
                f"{max(v['query_steps'])}): {NQ} solo {v['solo_mode']} runs "
                f"{sum(v['solo_ms']):.1f} ms = {v['solo_qps']:.1f} q/s (loops "
                f"{sum(v['solo_loop_ms']):.1f} ms); "
                "batched " + ", ".join(
                    f"{m} {v['modes'][m]['run_wall_ms']:.1f} ms = "
                    f"{v['modes'][m]['qps']:.1f} q/s "
                    f"({v['qps_vs_solo'][m]:.2f}x solo, loop "
                    f"{v['modes'][m]['loop_wall_ms']:.1f} ms = "
                    f"{v['ms_per_superstep'][m]:.2f} ms a superstep, peak "
                    f"{v['modes'][m]['peak_gib']:.2f} GiB)"
                    for m in ("host", *MODE_RUNS))
                + "; served " + ", ".join(
                    f"chunk {c}: {v['serving'][f'chunk{c}']['qps']:.1f} q/s, "
                    f"p50 / p99 {v['serving'][f'chunk{c}']['p50_steps']:.0f}"
                    f" / {v['serving'][f'chunk{c}']['p99_steps']:.0f} "
                    "supersteps" for c in SERVE_CHUNKS))

    print(f"[4/5] pagerank:personal solo from source 0, scale {FULL_SCALE}: "
          + ", ".join(f"{m} {pp_solo[m]['run_wall_ms']:.1f} ms"
                      for m in ("host", *MODE_RUNS))
          + f", bit-identical, oracle ok, segment_combine "
          f"{pp_solo['host']['launches']['segment_combine']} launches; "
          f"every batched and served lane bit-identical to its solo run: "
          + "; ".join(new_row(k, v) for k, v in (
              ("pagerank:personal", personal), ("pj:reqresp", pjb))),
          flush=True)
    print(f"[4/5] the lane route (one route pass a lane) against the union "
          f"route, Q={NQ}, fused, lanes equal: " + "; ".join(
              f"{k} lane {v['lane_run_wall_ms']:.1f} ms vs union "
              f"{v['union_run_wall_ms']:.1f} ms = {v['union_speedup']:.2f}x "
              f"(loop {v['lane_loop_wall_ms']:.1f} vs "
              f"{v['union_loop_wall_ms']:.1f} ms = "
              f"{v['union_loop_speedup']:.2f}x; peak {v['peak_gib']:.2f} vs "
              f"{v['union_peak_gib']:.2f} GiB)"
              for k, v in lane.items())
          + f" ({slice_s:.1f} s)", flush=True)

    # batched sssp:prop (the Propagation channel under the batched plane:
    # each lane its own fixpoint, the lanes the columns of every
    # segment_combine launch): 32 sources solo (fused), batched in every
    # mode (every lane, its info rows included, equal to its solo run;
    # launches equal on the device; a Q=20 batch with 12 pad lanes),
    # served at chunks 4 and 64; two lanes against the host oracle
    t = time.perf_counter()
    spp_spec = REGISTRY["sssp:prop"]
    spb, spp_prog, spp_queries, spp_host = batched_program_runs(
        spp_spec, sssp_graph, sssp_pg, "segment_combine", (), "fused",
        lane_key="info")
    spp_oracle_lanes = sorted(range(NQ), key=lambda qi: (
        -int(spp_host.state["info"][0, qi, 0]), qi))[:2]
    for qi in spp_oracle_lanes:
        spp_spec.check(sssp_graph, sssp_pg, SimpleNamespace(
            output=spp_host.outputs[qi]), {"source": spp_queries[qi]})
    spp_rounds = spp_host.state["info"][0, :NQ, 0].tolist()
    # the kernel's inputs at its three sites (local fixpoint, cut send,
    # cut receive) on 32 columns, as the batched step hands them over
    spp_calls = first_calls(ops, "segment_combine", lambda: Engine(
        mode="host").run_batch(spp_prog, sssp_pg, spp_queries))
    check([c[0][2] for c in spp_calls] == [
        sssp_pg.n_loc, sssp_pg.prop_out.cut.u_cap, sssp_pg.n_loc]
        and all(c[0][0].shape[-1] == NQ for c in spp_calls),
        f"batched sssp:prop's segment_combine sites "
        f"{[(list(c[0][0].shape), c[0][2]) for c in spp_calls]}")
    spp_s = time.perf_counter() - t
    detail["sssp_prop_batched"] = dict(spb, rounds=spp_rounds,
                                       oracle_lanes=spp_oracle_lanes,
                                       phase_s=spp_s)
    print(f"[4/5] batched sssp:prop, scale {FULL_SCALE}, W={W}, Q={NQ} "
          f"(lanes' global rounds {min(spp_rounds)}-{max(spp_rounds)}), "
          f"every lane (distances, info, bytes, msgs) bit-identical to its "
          f"solo run, oracle ok on lanes {spp_oracle_lanes}: "
          + new_row("sssp:prop", spb)
          + f"; segment_combine launches on the device in each mode "
          f"{spb['modes']['host']['launches_on_device']['segment_combine']}"
          f" ({spp_s:.1f} s)", flush=True)

    # the Propagation programs at full size, each path with its own launch
    # counts: wcc:prop on the wcc:basic partition (held to the ground
    # truth, fewer global rounds and bytes than wcc:basic), sssp:prop on
    # the sssp:basic partition (the oracle, sssp:basic's distances from
    # the same source), both scc variants on the registry's scc graph
    # (scipy's strong components, scc:prop below scc:basic in bytes)
    t = time.perf_counter()
    check(REGISTRY["wcc:prop"].build == wcc_spec.build
          and REGISTRY["sssp:prop"].build == sssp_spec.build,
          "wcc:prop/sssp:prop no longer share their basic variants' plans")
    scc_spec = REGISTRY["scc:prop"]
    scc_graph = scc_spec.make_graph(FULL_SCALE, 0)
    scc_pg = pgraph.partition_graph(scc_graph, W, "random",
                                    build=scc_spec.build)
    scc_host_s = time.perf_counter() - t
    prop_jobs = {"wcc:prop": (wcc_graph, wcc_pg),
                 "sssp:prop": (sssp_graph, sssp_pg),
                 "scc:basic": (scc_graph, scc_pg),
                 "scc:prop": (scc_graph, scc_pg)}
    prop_runs = {key: run_path(get_program(key), pg)
                 for key, (_, pg) in prop_jobs.items()}
    for key, run in prop_runs.items():
        check(run["launches"]["segment_combine"] > 0,
              f"{key} never launched segment_combine: {run['launches']}")
        check(run["res"].halted, f"{key} at scale {FULL_SCALE} did not halt")
    check(prop_runs["scc:basic"]["launches"]["bucket_ranks"] > 0,
          "scc:basic never launched bucket_ranks")
    t_or = time.perf_counter()
    wp = prop_runs["wcc:prop"]["res"]
    check(np.array_equal(canon(wp.output), truth),
          "wcc:prop labels differ from the ground truth")
    wp_rounds = int(wp.state["info"][:, 0].max())
    check(wp_rounds < wcc_res.steps and wp.total_bytes < wcc_res.total_bytes,
          f"wcc:prop ({wp_rounds} global rounds, {wp.total_bytes} bytes) "
          f"does not beat wcc:basic ({wcc_res.steps}, "
          f"{wcc_res.total_bytes}) at scale {FULL_SCALE}")
    sp = prop_runs["sssp:prop"]["res"]
    REGISTRY["sssp:prop"].check(sssp_graph, sssp_pg, sp, {"source": 0})
    sb = eng.run(get_program("sssp:basic", source=0), sssp_pg)
    check(bits_equal(sp.state["dist"], sb.state["dist"]),
          "sssp:prop distances differ from sssp:basic's")
    scc_truth = canon(strong_components(scc_graph))
    scc_p, scc_b = (prop_runs[k]["res"] for k in ("scc:prop", "scc:basic"))
    for key, res in (("scc:prop", scc_p), ("scc:basic", scc_b)):
        check(np.array_equal(canon(res.output), scc_truth),
              f"{key} differs from scipy's strong components")
    check(scc_p.total_bytes < scc_b.total_bytes,
          f"scc:prop ({scc_p.total_bytes} bytes) does not beat scc:basic "
          f"({scc_b.total_bytes}) at scale {FULL_SCALE}")
    prop_oracle_s = time.perf_counter() - t_or
    prop_main = {}
    for key, run in prop_runs.items():
        res = run.pop("res")
        graph = prop_jobs[key][0]
        counter = res.state[PROP_COUNTER[key]]
        prop_main[key] = dict(
            run, n=graph.n, edges=int(graph.num_edges), steps=res.steps,
            msgs=res.total_msgs, bytes=res.total_bytes,
            bytes_by_channel=res.bytes_by_channel,
            counter=counter.tolist(),
            step_ms=[1e3 * x for x in res.step_times_s],
            ms_per_superstep=run["run_wall_ms"] / max(res.steps, 1),
            loop_wall_s=res.wall_time_s)
    detail["prop_path"] = dict(
        prop_main, wcc_basic=dict(steps=wcc_res.steps,
                                  bytes=wcc_res.total_bytes),
        wcc_prop_rounds=wp_rounds, scc_components=int(scc_truth.max()) + 1,
        scc_host_setup_s=scc_host_s, oracle_s=prop_oracle_s,
        phase_s=time.perf_counter() - t)

    def prop_row(key):
        v = prop_main[key]
        return (f"{key} {v['steps']} steps, {v['bytes']} bytes, "
                f"{PROP_COUNTER[key]} {v['counter']}, "
                f"{v['ms_per_superstep']:.2f} ms a superstep, run "
                f"{v['run_wall_ms']:.1f} ms, peak {v['peak_gib']:.2f} GiB "
                f"({v['base_gib']:.2f} before), launches {v['launches']}")

    print(f"[4/5] the Propagation programs at scale {FULL_SCALE}, W={W}: "
          f"{prop_row('wcc:prop')}, labels = the ground truth, "
          f"{wp_rounds} global rounds vs wcc:basic's {wcc_res.steps} "
          f"supersteps, {wp.total_bytes} vs {wcc_res.total_bytes} bytes; "
          f"{prop_row('sssp:prop')}, oracle ok, distances = sssp:basic's "
          f"({sb.steps} supersteps); on {scc_graph.n} vertices, "
          f"{scc_graph.num_edges} edges, {int(scc_truth.max()) + 1} strong "
          f"components: {prop_row('scc:prop')}; {prop_row('scc:basic')}; "
          f"both = scipy's strong components, scc:prop below scc:basic in "
          f"bytes (scc graph set-up {scc_host_s:.1f} s, oracles "
          f"{prop_oracle_s:.1f} s; {time.perf_counter() - t:.1f} s)",
          flush=True)

    # the device modes at full size: all 21 programs on the partitions
    # built above (the seven with inner loops, which run as WHILE nodes of
    # the captured graph, among them), each in host mode and then fused,
    # chunked at K=64 and chunked at K=4 (two runs each: the first pays the
    # warm-up and the capture, the second replays the cached graph and is
    # the one reported), every device-mode run bit-identical to the host
    # run (state, supersteps, halts, bytes and msgs per channel) and
    # launching each kernel as often, as the kernels count their launches
    # on the device
    t = time.perf_counter()
    device_keys = tuple(REGISTRY)
    mode_jobs = {key: wcc_pg for key in device_keys
                 if key.split(":")[0] in ("wcc", "sv")}
    mode_jobs.update({"pagerank:basic": pr_pg, "pagerank:scatter": pr_pg,
                      "pagerank:personal": pr_pg,
                      "reach:basic": pr_pg, "sssp:basic": sssp_pg,
                      "sssp:prop": sssp_pg, "pj:basic": pj_pg,
                      "pj:reqresp": pj_pg, "msf:channels": msf_pg,
                      "msf:monolithic": msf_pg, "scc:basic": scc_pg,
                      "scc:prop": scc_pg})
    check(sorted(mode_jobs) == sorted(device_keys),
          "the device-mode programs and their partitions disagree")
    device_modes, fused_kept = {}, {}
    for key in device_keys:
        if key == "pagerank:personal":  # its runs from source 0 above
            device_modes[key] = pp_solo
            continue
        pg = mode_jobs[key]
        spec = REGISTRY[key]
        check(all(getattr(pg, plan) is not None for plan in spec.build),
              f"{key}: its partition lacks a plan of {spec.build}")
        knobs = dict(pj_in) if key.startswith("pj") else (
            {"iters": 30} if key.startswith("pagerank") else {})
        prog = spec.factory(**knobs)
        device_modes[key], fused_eng = mode_runs(prog, pg)
        if key in PROFILED_FUSED:  # its graph stays for the profiled run
            fused_kept[key] = (fused_eng, prog, pg)
        else:
            fused_eng.clear_cache()
    mode_s = time.perf_counter() - t
    detail["device_modes"] = dict(device_modes, phase_s=mode_s)

    def mode_row(key):
        v = device_modes[key]
        h = v["host"]
        return (f"{key} {h['steps']} steps: host {h['run_wall_ms']:.1f} ms "
                f"(loop {h['loop_wall_ms']:.1f}, "
                f"{h['overhead_ms_per_step']:.3f} ms host overhead a step); "
                + ", ".join(
                    f"{m} {v[m]['run_wall_ms']:.1f} ms (loop "
                    f"{v[m]['loop_wall_ms']:.1f}, capture "
                    f"{v[m]['capture_s']:.2f} s, {v[m]['dispatches']} "
                    f"dispatches, {v[m]['overhead_ms_per_step']:.3f} ms a "
                    f"step, peak {v[m]['peak_gib']:.2f} GiB)"
                    for m in MODE_RUNS)
                + f"; host peak {h['peak_gib']:.2f} GiB; launches on the "
                f"device in each mode " + (", ".join(
                    f"{n} {c}" for n, c in h["launches_on_device"].items()
                    if c) or "none"))

    print(f"[4/5] the device modes at scale {FULL_SCALE}, W={W} (ms: "
          f"Engine.run, init and extract included; loop: the superstep "
          f"loop alone), each run "
          f"bit-identical to host mode (state, supersteps, halts, bytes and "
          f"msgs per channel; kernel launches as the kernels count them "
          f"on the device): "
          + "; ".join(mode_row(k) for k in device_keys)
          + f" ({mode_s:.1f} s)", flush=True)

    # checkpoint/resume on the chunked CUDA-graph loop: wcc:basic and
    # sv:composed chunked at K=2, a checkpoint every two supersteps, a
    # resume from every checkpoint replaying the cached graph, each equal
    # to the uninterrupted run; then escalation from an eighth of every
    # capacity (fused): sv:composed, pagerank:basic, msf:channels and a
    # Q=32 run_batch of reach:basic, each recovered run equal to the plain
    # run and the second run a cache hit with no recovery
    t = time.perf_counter()
    ckpts = {}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR.parent) as tmp:
        for key in ("wcc:basic", "sv:composed"):
            d = Path(tmp) / key.replace(":", "_")
            ckpts[key] = checkpoint_runs(get_program(key), wcc_pg, d)
    for key, v in ckpts.items():
        check(v["launches"]["bucket_ranks"] > 0
              and v["launches_on_device"] == v["launches"],
              f"{key} checkpointed: launches {v['launches_on_device']} on the "
              f"device, {v['launches']} counted")
    ckpt_s = time.perf_counter() - t
    t = time.perf_counter()
    esc_jobs = {"sv:composed": (get_program("sv:composed"), wcc_pg),
                "pagerank:basic": (prb_prog, pr_pg),
                "msf:channels": (get_program("msf:channels"), msf_pg)}
    esc = {key: escalation_run(prog, pg, eng.run(prog, pg))
           for key, (prog, pg) in esc_jobs.items()}
    r_queries, _, r_host, _ = runs["reach:basic"]
    esc["reach:basic batched"] = escalation_run(
        REGISTRY["reach:basic"].factory(), pr_pg, r_host, r_queries)
    check(all(v["launches"]["bucket_ranks"] > 0 for k, v in esc.items()
              if k != "reach:basic batched")
          and esc["reach:basic batched"]["launches"]["bucket_ranks_lanes"]
          > 0, "an escalated run did not launch its routing kernel")
    esc_s = time.perf_counter() - t
    detail["resilience"] = dict(checkpoint=ckpts, escalation=esc,
                                checkpoint_s=ckpt_s, escalation_s=esc_s)

    def ckpt_row(key):
        v = ckpts[key]
        return (f"{key} {v['steps']} steps, {v['checkpoints']} checkpoints "
                f"of {v['bytes_per_checkpoint'] / 2**20:.1f} MiB (save "
                f"{v['save_ms']:.1f} ms, load {v['load_ms']:.1f} ms), run "
                f"{v['full_run_wall_ms']:.1f} ms with checkpoints vs "
                f"{v['plain_run_wall_ms']:.1f} without; resumed from step "
                + ", ".join(f"{r['step']} in {r['run_wall_ms']:.1f} ms"
                            for r in v["resumed"]))

    def esc_row(key):
        v = esc[key]
        return (f"{key} {v['attempts']} attempts (" + "; ".join(
            f"{ev['channels']}" + (f" lanes {ev['qids'][:4]}..."
                                   if ev["qids"] else "")
            for ev in v["trail"]) + f" -> {v['trail'][-1]['cap_scales']}), "
            f"captures {[round(c, 2) for c in v['capture_s']]} s, run "
            f"{v['run_wall_ms']:.1f} ms, second run {v['again_wall_ms']:.1f} "
            f"ms (hit), peak {v['peak_gib']:.2f} GiB")

    print(f"[4/5] checkpoint/resume at scale {FULL_SCALE}, chunked K=2, "
          f"every resume a replay of the cached graph and bit-identical to "
          f"the uninterrupted run: " + "; ".join(ckpt_row(k) for k in ckpts)
          + f" ({ckpt_s:.1f} s)", flush=True)
    print(f"[4/5] escalation from cap_scales {{'*': 0.125}}, fused, scale "
          f"{FULL_SCALE}, every recovered run bit-identical to the plain "
          f"run, the second a cache hit without recovery: "
          + "; ".join(esc_row(k) for k in esc) + f" ({esc_s:.1f} s)",
          flush=True)

    # python -m repro_torch bench-batch: every batchable program, each
    # lane held to its serial run before anything is timed
    bb = bench_batch_run(out_dir)
    detail["bench_batch"] = bb
    print(f"[4/5] bench-batch --queries {NQ} --scale {FULL_SCALE} --keys "
          f"{','.join(BENCH_BATCH_KEYS)} (fused, every lane bit-identical to "
          f"its serial run): " + "; ".join(
              f"{r['program']} serial {r['queries_per_s_serial']:.1f} q/s, "
              f"batched {r['queries_per_s_batched']:.1f} q/s = "
              f"{r['speedup']:.2f}x" for r in bb["rows"])
          + "; geomean " + ", ".join(
              f"{c} {g:.2f}x" for c, g in bb["geomean_speedup"].items())
          + f" ({bb['wall_s']:.1f} s)", flush=True)

    # the multi-device phase: Engine(backend="dist"), W=4 ranks on the
    # card, each job bit for bit against one process's host run
    dist = dist_phase(out_dir, smi)
    detail["dist"] = dist
    for line in dist_lines(dist):
        print(line, flush=True)

    # the planner at full size (planner_phase)
    plan_jobs = {}
    for key in device_keys:
        knobs = dict(pj_in) if key.startswith("pj") else (
            {"iters": 30} if key.startswith("pagerank") else {})
        plan_jobs[key] = (REGISTRY[key].factory(**knobs), mode_jobs[key])
    detail["planner"], plan_launches, plan_lanes = planner_phase(
        plan_jobs, (REGISTRY["reach:basic"].factory(), pr_pg,
                    runs["reach:basic"][0]), wcc_pg, truth, out_dir,
        Path(plan_cache.name))

    # -- 5. times at the scale-20 shapes ------------------------------------
    t = time.perf_counter()
    raw = wcc_pg.raw_out
    n_total = W * wcc_pg.n_loc
    u_dst, _ = routing.dedup_dense(raw.dst_global, raw.mask, n_total)
    # the first superstep's route keys: owner of each unique destination
    rkeys = torch.where(u_dst != routing.BIG, u_dst // wcc_pg.n_loc,
                        W).to(torch.int32)

    def bucket_times(what, fn):
        """Warm and L2-flushed device ms of one call, and the device
        kernels it runs: one launch of the kernel, no fill or memset."""
        per_call = kernels_per_call(fn)
        fills = sum(n for k, (n, _) in per_call.items()
                    if "Memset" in k or "Fill" in k)
        n = sum(n for n, _ in per_call.values())
        check(n - fills == 1 and fills <= 1,
              f"{what}: {n} device kernels per call ({fills} fills): "
              f"{per_call}")
        return dict(ms=cuda_ms(fn), cold_ms=cuda_ms_cold(fn),
                    kernels_per_call=per_call)

    rnd = torch.randint(0, W + 1, rkeys.shape, device=dev, dtype=torch.int32,
                        generator=g)
    b_t = {"sorted": bucket_times("bucket_ranks sorted",
                                  lambda: ops.bucket_ranks(rkeys, W)),
           "random": bucket_times("bucket_ranks random",
                                  lambda: ops.bucket_ranks(rnd, W))}
    b_ms = b_t["sorted"]["ms"]
    b_plain = cuda_ms(lambda: kref.bucket_ranks_ref(rkeys, W), reps=5)
    b_sort = cuda_ms(lambda: torch.sort(rkeys, dim=1, stable=True), reps=10)
    b_bytes = rkeys.numel() * 8 + W * W * 4
    b_bound = 1e3 * b_bytes / HBM_BYTES_PER_S

    l_rnd = torch.randint(0, W + 1, lkeys.shape, device=dev,
                          dtype=torch.int32, generator=g)
    lanes_rnd = ((torch.rand(lanes.shape, device=dev, generator=g) < 0.5)
                 & (l_rnd < W)[..., None])
    l_t = {"sorted": bucket_times(
        "bucket_ranks_lanes sorted",
        lambda: ops.bucket_ranks_lanes(lkeys, lanes, W)),
        "random": bucket_times(
        "bucket_ranks_lanes random",
        lambda: ops.bucket_ranks_lanes(l_rnd, lanes_rnd, W))}
    l_ms = l_t["sorted"]["ms"]
    l_plain = cuda_ms(lambda: kref.bucket_ranks_lanes_ref(lkeys, lanes, W),
                      reps=5)
    l_sort = cuda_ms(lambda: torch.sort(lkeys, dim=1, stable=True), reps=10)
    # key and rank 4 bytes each per entry, the Q membership bytes of each
    # real entry (a sentinel entry's are zero by contract and dropped), and
    # the (B + 1) x (Q + 1) counts per row; beside it the bound that reads
    # every entry's membership (PRs 12-13's reckoning)
    l_real = int((lkeys < W).sum())
    l_counts_bytes = W * (W + 1) * (NQ + 1) * 4
    l_bytes = lkeys.numel() * 8 + l_real * NQ + l_counts_bytes
    l_bytes_all = lkeys.numel() * (8 + NQ) + l_counts_bytes
    l_bound = 1e3 * l_bytes / HBM_BYTES_PER_S
    l_bound_all = 1e3 * l_bytes_all / HBM_BYTES_PER_S

    contrib = torch.rand((W, pr_pg.n_loc, 1), device=dev, generator=g)
    send_vals = contrib.gather(
        1, plan.edge_src.long()[..., None])  # (W, e_cap, 1), as the channel
    recv_vals = torch.rand((W, recv_n, 1), device=dev, generator=g)
    sides = ((send_vals, plan.edge_seg, u_cap),
             (recv_vals, plan.recv_sorted, pr_pg.n_loc))

    def real(s, n):  # entries whose id the kernel must read with a value
        return int(((s >= 0) & (s < n)).sum())

    seg_t = {}
    for side, (v, s, n) in zip(("send", "recv"), sides):
        rows, e, d = v.shape
        out_bytes = rows * n * d * 4
        # one-call yardsticks on a precomputed int64 index of the real
        # entries only, into a preset buffer (the identity fill is not
        # counted). Beside them the same index_add_ with every dropped
        # entry sent to one dump row per worker: a figure of the contention
        # that construction adds, not a yardstick.
        seg64 = s.long()
        keep = (seg64 >= 0) & (seg64 < n)
        idx_all = (torch.where(keep, seg64, n) + torch.arange(
            rows, device=dev)[:, None] * (n + 1)).reshape(-1)
        flat = v.reshape(-1, d)
        idx, real_vals = idx_all[keep.reshape(-1)], flat[keep.reshape(-1)]
        buf = torch.zeros((rows * (n + 1), d), device=dev)
        idx2 = idx[:, None].expand_as(real_vals)
        # torch.segment_reduce over one flat row: N + 1 segments per
        # worker, the last one swallowing the dropped pad entries
        lengths = torch.stack([torch.bincount(r.long(), minlength=n + 1)
                               for r in s]).reshape(-1)
        seg_t[side] = dict(
            shape=list(v.shape), n=n, real_entries=real(s, n),
            ms=cuda_ms(lambda: ops.segment_combine(v, s, n, cb.SUM)),
            cold_ms=cuda_ms_cold(lambda: ops.segment_combine(v, s, n, cb.SUM)),
            min_ms=cuda_ms(lambda: ops.segment_combine(v, s, n, cb.MIN)),
            plain_ms=cuda_ms(lambda: kref.segment_combine_ref(v, s, n, cb.SUM),
                             reps=5),
            index_add_ms=cuda_ms(lambda: buf.index_add_(0, idx, real_vals)),
            scatter_reduce_amin_ms=cuda_ms(lambda: buf.scatter_reduce_(
                0, idx2, real_vals, "amin", include_self=True)),
            dump_row_index_add_ms=cuda_ms(
                lambda: buf.index_add_(0, idx_all, flat)),
            segment_reduce_ms=cuda_ms(lambda: torch.segment_reduce(
                flat, "sum", lengths=lengths, unsafe=True)),
            bytes=real(s, n) * (4 + 4 * d) + out_bytes,
            all_entry_bytes=rows * e * (4 + 4 * d) + out_bytes)
    for side, (v, s, n) in zip(("send", "recv"), sides):
        # two device kernels a call (the tile and join passes), no fill
        # and no memset: the chunk table clears its own marks
        per_call = kernels_per_call(
            lambda: ops.segment_combine(v, s, n, cb.SUM))
        fills = sum(c for k, (c, _) in per_call.items()
                    if "Memset" in k or "Fill" in k)
        count = sum(c for c, _ in per_call.values())
        check(count == 2 and fills == 0,
              f"segment_combine {side}: {count} device kernels a call "
              f"({fills} fills): {per_call}")
        seg_t[side]["kernels_per_call"] = per_call
    st = {k: sum(x[k] for x in seg_t.values()) for k in (
        "ms", "cold_ms", "min_ms", "plain_ms", "index_add_ms",
        "scatter_reduce_amin_ms", "dump_row_index_add_ms",
        "segment_reduce_ms", "bytes", "all_entry_bytes")}
    s_ms, s_plain = st["ms"], st["plain_ms"]
    # the same function as the kernel's timed sum, one PyTorch call a side
    s_lib_name, s_lib = min((("index_add_", st["index_add_ms"]),
                             ("segment_reduce", st["segment_reduce_ms"])),
                            key=lambda x: x[1])
    s_bound = 1e3 * st["bytes"] / HBM_BYTES_PER_S
    s_bound_all = 1e3 * st["all_entry_bytes"] / HBM_BYTES_PER_S

    # segment_combine as the S-V neighbour minimum: int32 min per
    # superstep at the sv plan (send: the vertex ids per edge, as the
    # first superstep gathers them; recv: random ids on the wire), beside
    # one scatter_reduce_ amin a side on the real entries into a preset
    # buffer (the identity fill not counted)
    sv_ids = wcc_pg.global_ids()
    sv_sides = (
        (sv_ids.gather(1, sv_plan.edge_src.long())[..., None],
         sv_plan.edge_seg, sv_plan.u_cap),
        (torch.randint(0, W * wcc_pg.n_loc, sv_plan.recv_sorted.shape + (1,),
                       device=dev, dtype=torch.int32, generator=g),
         sv_plan.recv_sorted, wcc_pg.n_loc))
    sv_t = {}
    for side, (v, s, n) in zip(("send", "recv"), sv_sides):
        rows, e, d = v.shape
        seg64 = s.long()
        keep = (seg64 >= 0) & (seg64 < n)
        idx = (seg64 + torch.arange(rows, device=dev)[:, None] * (n + 1))[
            keep]
        real_vals = v.reshape(-1, d)[keep.reshape(-1)]
        buf = torch.full((rows * (n + 1), d), INT32_MAX, dtype=torch.int32,
                         device=dev)
        idx2 = idx[:, None].expand_as(real_vals)
        sv_t[side] = dict(
            shape=list(v.shape), n=n, real_entries=real(s, n),
            ms=cuda_ms(lambda: ops.segment_combine(v, s, n, cb.MIN)),
            cold_ms=cuda_ms_cold(lambda: ops.segment_combine(v, s, n, cb.MIN)),
            plain_ms=cuda_ms(lambda: kref.segment_combine_ref(v, s, n, cb.MIN),
                             reps=5),
            scatter_reduce_amin_ms=cuda_ms(lambda: buf.scatter_reduce_(
                0, idx2, real_vals, "amin", include_self=True)),
            bytes=real(s, n) * (4 + 4 * d) + rows * n * d * 4)
    svs = {k: sum(x[k] for x in sv_t.values()) for k in (
        "ms", "cold_ms", "plain_ms", "scatter_reduce_amin_ms", "bytes")}
    sv_bound = 1e3 * svs["bytes"] / HBM_BYTES_PER_S
    sv_min_entry = dict(
        what=f"int32 min, send + recv at the scale-{FULL_SCALE} S-V plan",
        send_shape=sv_t["send"]["shape"], recv_shape=sv_t["recv"]["shape"],
        launches=sv_launches["segment_combine"], max_abs_err=0.0,
        ms=svs["ms"], cold_ms=svs["cold_ms"], plain_ms=svs["plain_ms"],
        bound_ms=sv_bound, bound_by="bytes",
        library_ms=svs["scatter_reduce_amin_ms"],
        library="scatter_reduce_ amin")
    # the rest of the paper's table: min_by_first at the msf plan (row
    # 2b) and the float32 sum of pagerank:basic's CombinedMessage (row 2c),
    # on the first superstep's captured inputs, both sides
    mbf_t = dispatch_times(msf_calls, two_pass_yardstick)
    csum_t = dispatch_times(pr_calls, index_add_yardstick)
    seg_source = "src/repro_torch/kernels/csrc/segment_combine.cu"
    seg_replaces = "src/repro/kernels/segment_combine.py:101"
    mbf_launches = sum(new_main[k]["launches"]["segment_combine"]
                       for k in ("msf:channels", "msf:monolithic"))
    row_2b = dict(
        name="segment_combine: min_by_first (2b)", route="cuda",
        source=seg_source, replaces=seg_replaces, launches=mbf_launches,
        launches_by_path={k: new_main[k]["launches"]["segment_combine"]
                          for k in ("msf:channels", "msf:monolithic")},
        max_abs_err=errs["min_by_first"], ms=mbf_t["ms"],
        plain_ms=mbf_t["plain_ms"], bound_ms=mbf_t["bound_ms"],
        bound_by="bytes", library_ms=mbf_t["library_ms"],
        library="scatter_reduce_ amin + scatter_reduce_ amax + gather",
        cold_ms=mbf_t["cold_ms"], dispatch_ms=mbf_t["dispatch_ms"],
        what=f"the first superstep's candidate combine of msf at scale "
             f"{FULL_SCALE}, send + recv")
    row_2c = dict(
        name="segment_combine: float32 sum, CombinedMessage (2c)",
        route="cuda", source=seg_source, replaces=seg_replaces,
        launches=new_main["pagerank:basic"]["launches"]["segment_combine"],
        max_abs_err=errs["combined_sum"], ms=csum_t["ms"],
        plain_ms=csum_t["plain_ms"], bound_ms=csum_t["bound_ms"],
        bound_by="bytes", library_ms=csum_t["library_ms"],
        library="index_add_", cold_ms=csum_t["cold_ms"],
        dispatch_ms=csum_t["dispatch_ms"],
        what=f"pagerank:basic's CombinedMessage at scale {FULL_SCALE}, "
             f"send + recv")

    # row 2d: the propagation fixpoint's int32 min at wcc:prop's int_dst
    # (vertex ids gathered by int_src, as its first iteration hands them
    # over), beside one scatter_reduce_ amin on the real entries into a
    # preset buffer (the identity fill not counted)
    pv = wcc_pg.global_ids().gather(1, prop_plan.int_src.long())[..., None]
    ps, pn = prop_plan.int_dst, wcc_pg.n_loc
    p_keep = ps.long() < pn
    p_idx = (ps.long() + torch.arange(W, device=dev)[:, None] * (pn + 1))[
        p_keep][:, None]
    p_real_vals = pv.reshape(-1, 1)[p_keep.reshape(-1)]
    p_buf = torch.full((W * (pn + 1), 1), INT32_MAX, dtype=torch.int32,
                       device=dev)
    p_real = real(ps, pn)
    p_bytes = p_real * 8 + W * pn * 4
    row_2d = dict(
        name="segment_combine: int32 min, propagation int_dst (2d)",
        route="cuda", source=seg_source, replaces=seg_replaces,
        launches=prop_main["wcc:prop"]["launches"]["segment_combine"],
        launches_by_path={k: v["launches"]["segment_combine"]
                          for k, v in prop_main.items()},
        max_abs_err=0.0,
        ms=cuda_ms(lambda: ops.segment_combine(pv, ps, pn, cb.MIN)),
        cold_ms=cuda_ms_cold(lambda: ops.segment_combine(pv, ps, pn,
                                                         cb.MIN)),
        plain_ms=cuda_ms(lambda: kref.segment_combine_ref(pv, ps, pn, cb.MIN),
                         reps=5),
        bound_ms=1e3 * p_bytes / HBM_BYTES_PER_S, bound_by="bytes",
        library_ms=cuda_ms(lambda: p_buf.scatter_reduce_(
            0, p_idx, p_real_vals, "amin", include_self=True)),
        library="scatter_reduce_ amin", shape=list(pv.shape), segments=pn,
        real_entries=p_real, bytes=p_bytes,
        what=f"one local-fixpoint iteration of wcc:prop at scale "
             f"{FULL_SCALE}: (W, ei_cap, 1) by int_dst into n_loc")
    prop_seg = sum(v["launches"]["segment_combine"]
                   for v in prop_main.values())

    # rows 2e and 3a: segment_combine on pagerank:personal's Q·D columns
    # (send and receive, as the batched step hands them over: each column
    # bit-exact against its D=1 call), bucket_ranks_lanes at the
    # _request_union shape of batched pj:reqresp
    t_q = time.perf_counter()
    qd_check = column_checks(pp_calls, "pagerank:personal Q·D")
    qd_t = column_times(pp_calls)
    ru_t = union_lanes_times(pj_calls[0])
    row_2e = dict(
        name="segment_combine: float32 sum on Q·D columns (2e)",
        route="cuda", source=seg_source, replaces=seg_replaces,
        launches=personal["modes"]["host"]["launches"]["segment_combine"],
        launches_by_path={
            "pagerank:personal solo": pp_solo["host"]["launches"][
                "segment_combine"],
            **{f"pagerank:personal batched {m}": personal["modes"][m][
                "launches_on_device"]["segment_combine"]
               for m in ("host", *MODE_RUNS)}},
        max_abs_err=qd_check["max_abs_err"], ms=qd_t["ms"],
        plain_ms=qd_t["plain_ms"], bound_ms=qd_t["bound_ms"],
        bound_by="bytes", library_ms=qd_t["library_ms"],
        library="index_add_", cold_ms=qd_t["cold_ms"],
        send_shape=qd_t["send"]["shape"], recv_shape=qd_t["recv"]["shape"],
        what=f"pagerank:personal's batched superstep at scale {FULL_SCALE}, "
             f"Q={NQ} lanes as columns, send + recv")
    row_3a = dict(
        name="bucket_ranks_lanes: _request_union (3a)", route="cuda",
        source="src/repro_torch/kernels/csrc/bucket_route.cu",
        replaces="src/repro/kernels/bucket_route.py:128",
        launches=pjb["modes"]["host"]["launches"]["bucket_ranks_lanes"],
        launches_by_path={
            f"pj:reqresp batched {m}": pjb["modes"][m]["launches_on_device"][
                "bucket_ranks_lanes"] for m in ("host", *MODE_RUNS)},
        max_abs_err=0.0, ms=ru_t["ms"], plain_ms=ru_t["plain_ms"],
        bound_ms=ru_t["bound_ms"], bound_by="bytes",
        library_ms=ru_t["library_ms"], library="stable torch.sort of the keys",
        cold_ms=ru_t["cold_ms"], shape=ru_t["shape"],
        real_entries=ru_t["real_entries"],
        what=f"batched pj:reqresp's union request at scale {FULL_SCALE}, "
             f"Q={NQ} forests")
    print(f"[5/5] kernel 2 on pagerank:personal's Q·D columns (send "
          f"{qd_t['send']['shape']} into {qd_t['send']['n']}, recv "
          f"{qd_t['recv']['shape']} into {qd_t['recv']['n']}): every column "
          f"bit-exact against its D=1 call, max|err| vs plain "
          f"{qd_check['max_abs_err']:.3g}; {qd_t['ms']:.4f} ms warm [send "
          f"{qd_t['send']['ms']:.4f}, recv {qd_t['recv']['ms']:.4f}], "
          f"{qd_t['cold_ms']:.4f} L2 flushed, plain {qd_t['plain_ms']:.3f}, "
          f"bound {qd_t['bound_ms']:.4f}, index_add_ {qd_t['library_ms']:.4f};"
          f" kernel 3 at the _request_union shape {ru_t['shape']} "
          f"({ru_t['real_entries']} real entries) exact, {ru_t['ms']:.4f} ms "
          f"warm, {ru_t['cold_ms']:.4f} L2 flushed, plain "
          f"{ru_t['plain_ms']:.3f}, bound {ru_t['bound_ms']:.4f}, stable "
          f"torch.sort {ru_t['library_ms']:.4f} "
          f"({time.perf_counter() - t_q:.1f} s)", flush=True)

    # row 2f: segment_combine's float32 min on batched sssp:prop's 32
    # columns at its three sites (a local-fixpoint iteration, the cut
    # send, the cut receive), as the batched step hands them over: each
    # column bit-exact against its D=1 call, the whole against plain
    t_f = time.perf_counter()
    f_sides = ("int_dst", "cut send", "cut recv")
    f_check = column_checks(spp_calls, "sssp:prop Q columns")
    for (vals, ids, n, comb), _ in spp_calls:
        check(bits_equal(ops.segment_combine(vals, ids, n, comb),
                         kref.segment_combine_ref(vals, ids, n, comb)),
              f"segment_combine min {list(vals.shape)} differs from plain")
    f_t = column_times(spp_calls, amin_yardstick, f_sides)
    row_2f = dict(
        name="segment_combine: float32 min on Q columns (2f)", route="cuda",
        source=seg_source, replaces=seg_replaces,
        launches=spb["modes"]["host"]["launches"]["segment_combine"],
        launches_by_path={
            f"sssp:prop batched {m}": spb["modes"][m]["launches_on_device"][
                "segment_combine"] for m in ("host", *MODE_RUNS)},
        max_abs_err=f_check["max_abs_err"], ms=f_t["ms"],
        plain_ms=f_t["plain_ms"], bound_ms=f_t["bound_ms"], bound_by="bytes",
        library_ms=f_t["library_ms"], library="scatter_reduce_ amin",
        cold_ms=f_t["cold_ms"],
        shapes={x: [f_t[x]["shape"], f_t[x]["n"]] for x in f_sides},
        what=f"batched sssp:prop's first superstep at scale {FULL_SCALE}, "
             f"Q={NQ} lanes as columns: one local-fixpoint iteration + the "
             "cut send + the cut receive")
    print(f"[5/5] kernel 2 float32 min on batched sssp:prop's {NQ} columns ("
          + ", ".join(f"{x} {f_t[x]['shape']} into {f_t[x]['n']} "
                      f"{f_t[x]['ms']:.4f} ms" for x in f_sides)
          + f"): every column bit-exact against its D=1 call and the whole "
          f"against plain; {f_t['ms']:.4f} ms warm, {f_t['cold_ms']:.4f} L2 "
          f"flushed, plain {f_t['plain_ms']:.3f}, bound "
          f"{f_t['bound_ms']:.4f}, scatter_reduce_ amin "
          f"{f_t['library_ms']:.4f} ({time.perf_counter() - t_f:.1f} s)",
          flush=True)

    # the launches of this slice's paths, by kernel: checkpointed and
    # escalated runs, and batched sssp:prop in host mode
    new_paths = {f"{k} checkpointed": v["launches"] for k, v in ckpts.items()}
    new_paths.update({f"{k} escalated": v["launches"]
                      for k, v in esc.items() if "batched" not in k})
    new_launches = {
        "bucket_ranks": {k: v["bucket_ranks"] for k, v in new_paths.items()
                         if v["bucket_ranks"]},
        "segment_combine": {k: v["segment_combine"]
                            for k, v in new_paths.items()
                            if v["segment_combine"]}}
    new_launches["segment_combine"]["sssp:prop batched"] = spb["modes"][
        "host"]["launches"]["segment_combine"]
    for kern, paths in plan_launches.items():
        new_launches[kern].update(paths)
    # the multi-device phase: each rank launches what the local run's
    # wrappers count (checked there); the column counts every rank
    dist_lanes = {}
    for jname, r in dist["rows"].items():
        for kern, n in r["launches"].items():
            if n:
                key = f"{jname} on {DIST_WORLD} ranks ({n} each)"
                (dist_lanes if kern == "bucket_ranks_lanes"
                 else new_launches[kern])[key] = n * DIST_WORLD
    kernels = [
        dict(name="bucket_ranks", route="cuda",
             source="src/repro_torch/kernels/csrc/bucket_route.cu",
             replaces="src/repro/kernels/bucket_route.py:87",
             launches=(launches["bucket_ranks"] + sv_launches["bucket_ranks"]
                       + prop_main["scc:basic"]["launches"]["bucket_ranks"]
                       + sum(new_launches["bucket_ranks"].values())),
             launches_by_path=dict(
                 wcc_basic=launches["bucket_ranks"],
                 sv_composed=sv_launches["bucket_ranks"],
                 scc_basic=prop_main["scc:basic"]["launches"][
                     "bucket_ranks"], **new_launches["bucket_ranks"]),
             max_abs_err=errs["bucket_ranks"], ms=b_ms, plain_ms=b_plain,
             bound_ms=b_bound, bound_by="bytes", library_ms=None,
             cold_ms=b_t["sorted"]["cold_ms"], random_ms=b_t["random"]["ms"],
             random_cold_ms=b_t["random"]["cold_ms"]),
        dict(name="segment_combine", route="cuda",
             source="src/repro_torch/kernels/csrc/segment_combine.cu",
             replaces="src/repro/kernels/segment_combine.py:101",
             launches=(launches["segment_combine"]
                       + sv_launches["segment_combine"] + prop_seg
                       + sum(new_launches["segment_combine"].values())),
             launches_by_path=dict(
                 pagerank_scatter=launches["segment_combine"],
                 sv_composed=sv_launches["segment_combine"],
                 **{k: v["launches"]["segment_combine"]
                    for k, v in prop_main.items()},
                 **new_launches["segment_combine"]),
             max_abs_err=errs["segment_combine"], ms=s_ms, plain_ms=s_plain,
             bound_ms=s_bound, bound_by="bytes", library_ms=s_lib,
             library=s_lib_name, cold_ms=st["cold_ms"],
             all_entry_bound_ms=s_bound_all, int32_min_sv=sv_min_entry),
        dict(name="bucket_ranks_lanes", route="cuda",
             source="src/repro_torch/kernels/csrc/bucket_route.cu",
             replaces="src/repro/kernels/bucket_route.py:128",
             launches=(b_launches["bucket_ranks_lanes"]
                       + esc["reach:basic batched"]["launches"][
                           "bucket_ranks_lanes"] + plan_lanes
                       + sum(dist_lanes.values())),
             launches_by_path={
                 **dist_lanes,
                 "reach:basic batched escalated": esc[
                     "reach:basic batched"]["launches"][
                     "bucket_ranks_lanes"],
                 "reach:basic batched planned": plan_lanes,
                 **{f"{k} {m}": v[m]["launches_on_device"][
                     "bucket_ranks_lanes"]
                    for k, v in batch_modes.items()
                    for m in ("host", *MODE_RUNS)},
                 **{f"{k} serve {c}": v[c]["launches_on_device"][
                     "bucket_ranks_lanes"]
                    for k, v in serving.items() for c in v
                    if c.startswith("chunk")}},
             max_abs_err=errs["bucket_ranks_lanes"], ms=l_ms,
             plain_ms=l_plain, bound_ms=l_bound, bound_by="bytes",
             library_ms=None, cold_ms=l_t["sorted"]["cold_ms"],
             random_ms=l_t["random"]["ms"],
             random_cold_ms=l_t["random"]["cold_ms"],
             all_entry_bound_ms=l_bound_all),
        row_2b, row_2c, row_2d, row_2e, row_3a, row_2f,
        *detail["fault11"]["rows"],
    ]
    detail["timings"] = dict(
        bucket_ranks=dict(shape=list(rkeys.shape), **b_t, plain_ms=b_plain,
                          stable_sort_ms=b_sort, bytes=b_bytes,
                          bound_ms=b_bound),
        bucket_ranks_lanes=dict(shape=list(lanes.shape), **l_t,
                                plain_ms=l_plain, stable_sort_ms=l_sort,
                                real_entries=l_real, bytes=l_bytes,
                                bound_ms=l_bound, all_entry_bytes=l_bytes_all,
                                all_entry_bound_ms=l_bound_all),
        segment_combine=dict(seg_t, **st, library=s_lib_name,
                             bound_ms=s_bound, all_entry_bound_ms=s_bound_all),
        segment_combine_int32_min_sv=dict(sv_t, **svs, bound_ms=sv_bound),
        segment_combine_min_by_first=mbf_t,
        segment_combine_combined_sum=csum_t,
        segment_combine_personal_columns=dict(qd_t, checks=qd_check),
        segment_combine_sssp_prop_columns=dict(f_t, checks=f_check),
        bucket_ranks_lanes_request_union=ru_t)

    def warm_cold(t):
        s, r = t["sorted"], t["random"]
        return (f"sorted {s['ms']:.4f} / {s['cold_ms']:.4f}, random "
                f"{r['ms']:.4f} / {r['cold_ms']:.4f} ms warm / L2 flushed, "
                f"1 device kernel a call")

    print(f"[5/5] times at scale {FULL_SCALE}: bucket_ranks {list(rkeys.shape)}"
          f" {warm_cold(b_t)} (plain {b_plain:.3f}, bound {b_bound:.4f}, "
          f"library none; stable torch.sort {b_sort:.3f}); segment_combine "
          f"per "
          f"superstep (send {list(send_vals.shape)} + recv "
          f"{list(recv_vals.shape)}) {s_ms:.4f} ms warm [send "
          f"{seg_t['send']['ms']:.4f}, recv {seg_t['recv']['ms']:.4f}], "
          f"{st['cold_ms']:.4f} ms L2 flushed [send "
          f"{seg_t['send']['cold_ms']:.4f}, recv "
          f"{seg_t['recv']['cold_ms']:.4f}], 2 device kernels a call, min "
          f"{st['min_ms']:.4f} (plain "
          f"{s_plain:.3f}, bound {s_bound:.4f} on real entries, "
          f"{s_bound_all:.4f} on all e_cap entries; on the real entries "
          f"index_add_ {st['index_add_ms']:.4f}, scatter_reduce_ amin "
          f"{st['scatter_reduce_amin_ms']:.4f}; index_add_ with a dump row "
          f"{st['dump_row_index_add_ms']:.4f}; torch.segment_reduce "
          f"{st['segment_reduce_ms']:.4f}); "
          f"bucket_ranks_lanes {list(lanes.shape)} {warm_cold(l_t)} (plain "
          f"{l_plain:.3f}, bound {l_bound:.4f} reading the membership of the "
          f"{l_real} real entries, {l_bound_all:.4f} of all entries; library "
          f"none; stable torch.sort of the keys {l_sort:.3f}); "
          f"segment_combine int32 min per S-V superstep (send "
          f"{sv_t['send']['shape']} + recv {sv_t['recv']['shape']}) "
          f"{svs['ms']:.4f} ms warm [send {sv_t['send']['ms']:.4f}, recv "
          f"{sv_t['recv']['ms']:.4f}], {svs['cold_ms']:.4f} L2 flushed "
          f"(plain {svs['plain_ms']:.3f}, bound {sv_bound:.4f} on real "
          f"entries, scatter_reduce_ amin on the real entries "
          f"{svs['scatter_reduce_amin_ms']:.4f}) "
          f"({time.perf_counter() - t:.1f} s)", flush=True)

    def dispatch_row(name, x):
        return (f"{name} (send {x['send']['shape']} into {x['send']['n']}, "
                f"recv {x['recv']['shape']} into {x['recv']['n']}) kernel "
                f"{x['ms']:.4f} ms warm [send {x['send']['ms']:.4f}, recv "
                f"{x['recv']['ms']:.4f}], {x['cold_ms']:.4f} L2 flushed; "
                f"with the stable sort and gather {x['dispatch_ms']:.4f}; "
                f"plain {x['plain_ms']:.3f}, bound {x['bound_ms']:.4f}, "
                f"yardstick {x['library_ms']:.4f}")

    print(f"[5/5] times of the new combines at scale {FULL_SCALE}: "
          f"{dispatch_row('min_by_first at the msf plan', mbf_t)} "
          f"(scatter_reduce_ amin + amax + gather); "
          f"{dispatch_row('float32 sum at the pagerank:basic CombinedMessage', csum_t)}"
          f" (index_add_); int32 min at the wcc:prop plan's int_dst "
          f"({row_2d['shape']} into {pn}, {p_real} real entries) "
          f"{row_2d['ms']:.4f} ms warm, {row_2d['cold_ms']:.4f} L2 flushed "
          f"(plain {row_2d['plain_ms']:.3f}, bound {row_2d['bound_ms']:.4f}, "
          f"scatter_reduce_ amin {row_2d['library_ms']:.4f}), launches "
          f"{row_2d['launches_by_path']}", flush=True)

    s_queries, s_prog, _, s_ms = runs["sssp:basic"]
    detail["profile"] = profile_runs(
        (("wcc:basic", lambda: eng.run(get_program("wcc:basic"), wcc_pg),
          wcc_ms),
         ("pagerank:scatter", lambda: eng.run(pr_prog, pr_pg), pr_ms),
         ("sssp:basic batched", lambda: eng.run_batch(s_prog, sssp_pg,
                                                      s_queries), s_ms),
         ("sv:composed", lambda: eng.run(get_program("sv:composed"), wcc_pg),
          sv_main["sv:composed"]["run_wall_ms"]),
         ("pagerank:basic", lambda: eng.run(prb_prog, pr_pg),
          new_main["pagerank:basic"]["run_wall_ms"]),
         ("msf:channels", lambda: eng.run(get_program("msf:channels"),
                                          msf_pg),
          new_main["msf:channels"]["run_wall_ms"]),
         *((key, lambda key=key: eng.run(get_program(key),
                                         prop_jobs[key][1]),
            prop_main[key]["run_wall_ms"]) for key in prop_main),
         *((f"{key} fused", lambda key=key: fused_kept[key][0].run(
             *fused_kept[key][1:]),
            device_modes[key]["fused"]["run_wall_ms"])
           for key in PROFILED_FUSED)),
        out_dir)
    for fused_eng, _, _ in fused_kept.values():
        fused_eng.clear_cache()
    print("[5/5] profiled runs: " + "; ".join(
        f"{k}: traced wall {v['wall_ms']:.1f} ms, device "
        f"{v['device_ms']:.1f} ms, busy {v['busy_share']:.2f} (traced run); "
        f"untraced phase-4 wall {v['untraced_wall_ms']:.1f} ms, device/"
        f"untraced {v['busy_vs_untraced']:.2f}; top kernel "
        f"{v['kernels'][0][0][:40]} {v['kernels'][0][1]:.1f} ms; launches "
        f"in the trace {v['launches_in_trace']}, on the device "
        f"{v['launches_on_device']}"
        for k, v in detail["profile"].items()), flush=True)
    with torch.no_grad():
        detail["lm"]["traced"] = lm_traced(dev, out_dir)
    print(lm_traced_line(detail["lm"]["traced"], smi), flush=True)
    (out_dir / "lm_serve.json").write_text(json.dumps(detail["lm"], indent=1))
    tt = train_traced(dev, out_dir, detail["train"]["full"]["median_ms"])
    detail["train"]["traced"] = tt
    print(f"[5/5] {TRAIN_ARCH} train step traced: device "
          f"{tt['device_ms']:.1f} of {tt['untraced_ms']:.1f} ms untraced "
          f"(busy {tt['busy_vs_untraced']:.2f}), {tt['kernels_a_step']:.0f} "
          f"device kernels a step; top {tt['top'][0][0][:50]} "
          f"{tt['top'][0][1]:.1f} ms | {smi}", flush=True)
    (out_dir / "train.json").write_text(json.dumps(detail["train"],
                                                   indent=1))
    detail["total_s"] = time.perf_counter() - t_start
    plan_cache.cleanup()
    print(f"chip_smoke: all phases ok in {detail['total_s']:.1f} s",
          flush=True)
    (out_dir / "chip_smoke.json").write_text(
        json.dumps(dict(detail, kernels=kernels), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
