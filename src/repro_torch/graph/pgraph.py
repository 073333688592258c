"""PartitionedGraph — static-shape distributed graph with channel plans.

The port of ``repro.graph.pgraph``. Every routing decision is precomputed
host-side in numpy into dense, static-shape tables with a leading ``W``
(worker) axis, exactly as the JAX package builds them, and moved to the
device once (:func:`from_arrays`). The channels index the tables with
all W workers at once.

Differences from the JAX plans:

  - the TPU tiling tables of the segment-combine kernel (``chunk_start``,
    ``chunk_count``, ``block_rows``, ``block_edges``, ``max_chunks``) are
    not built: the CUDA kernel finds its segments itself;
  - a ScatterPlan also carries ``recv_order``/``recv_sorted``, a stable
    host-side sort of each worker's ``recv_local`` table, so the
    receive-side combine is a sorted segment combine (the CUDA kernel,
    deterministic) instead of a scatter with float atomics; so does
    the cut plan of a :class:`PropPlan`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph import partition as partition_lib
from repro_torch.graph.generators import EdgeList
from repro_torch.pregel.errors import PlanRangeError

INT32_MAX = 2**31 - 1
PLANS = ("scatter_out", "scatter_in", "prop_out", "prop_in", "raw_out",
         "raw_in")
# tables/statics of the JAX ScatterPlan that only tile the TPU kernel
_TPU_ONLY = ("chunk_start", "chunk_count", "block_rows", "block_edges",
             "max_chunks")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_int32_extent(what: str, value: int) -> None:
    """Plan tables and wire slots are int32; any extent past 2**31 - 1
    would silently wrap into another worker's range and corrupt routes."""
    if value > INT32_MAX:
        raise PlanRangeError(
            f"{what} = {value} exceeds the int32 range ({INT32_MAX}); "
            "the wire-slot ids (owner * C + rank) and plan tables would "
            "wrap. Reduce workers x capacity (or shrink the graph/caps).",
            channels=(what,),
        )


def _bucket_cap(x: int, align: int) -> int:
    """Slot caps are bucketed to the next power of two (floored at
    ``align``), as in the JAX package."""
    x = max(x, 1)
    return max(align, 1 << (x - 1).bit_length())


def _tensor(arr, device):
    # np.array copies: the source may be a read-only view (e.g. of a JAX
    # array), which torch.from_numpy refuses to share
    return None if arr is None else torch.from_numpy(
        np.array(arr, order="C")).to(device)


@dataclasses.dataclass
class ScatterPlan:
    """Static routing plan for the scatter-combine pattern (per worker:
    local edges sorted by destination, sender-side dedup to one entry per
    unique destination, positional slots into the exchange buffer, and
    the receive-side local indices)."""

    edge_src: torch.Tensor     # (W, E_cap) i32 local src idx (pad 0)
    edge_seg: torch.Tensor     # (W, E_cap) i32 unique-dst idx, sorted (pad U_cap)
    edge_w: Optional[torch.Tensor]  # (W, E_cap) f32 edge weights or None
    pack_slot: torch.Tensor    # (W, U_cap) i32 slot in (W*C) send buf (pad W*C)
    recv_local: torch.Tensor   # (W, W, C) i32 local dst idx (pad n_loc)
    send_count: torch.Tensor   # (W, W) i32 real entries per peer
    recv_order: torch.Tensor   # (W, W*C) i32 stable argsort of recv_local
    recv_sorted: torch.Tensor  # (W, W*C) i32 recv_local in that order
    n_loc: int
    num_workers: int
    e_cap: int
    u_cap: int
    slot_cap: int
    remote_entries: int
    total_edges: int
    # hub mirroring (partition_graph(mirror_threshold=...)): edge_src may
    # index n_loc + owner * hub_cap + hub_rank, a mirror of a remote hub
    hub_local: Optional[torch.Tensor] = None  # (W, hub_cap) i32 (pad n_loc)
    hub_cap: int = 0
    mirrored_edges: int = 0


@dataclasses.dataclass
class RawEdges:
    """Unsorted per-worker edge lists (src local) — what the baseline
    message channels iterate over each superstep."""

    src_local: torch.Tensor   # (W, E_cap) i32
    dst_global: torch.Tensor  # (W, E_cap) i32
    w: Optional[torch.Tensor]  # (W, E_cap) f32
    mask: torch.Tensor        # (W, E_cap) bool
    e_cap: int


@dataclasses.dataclass
class PropPlan:
    """Plan for the propagation channel: a partition-internal CSR (for
    the local fixpoint) plus a ScatterPlan over the cut edges (for the
    global exchange)."""

    int_src: torch.Tensor      # (W, Ei_cap) i32 local src idx (pad 0)
    int_dst: torch.Tensor      # (W, Ei_cap) i32 local dst idx, sorted (pad n_loc)
    int_w: Optional[torch.Tensor]  # (W, Ei_cap) f32 edge weights or None
    cut: ScatterPlan
    ei_cap: int


@dataclasses.dataclass
class PartitionedGraph:
    v_mask: torch.Tensor      # (W, n_loc) bool
    deg_out: torch.Tensor     # (W, n_loc) i32
    scatter_out: Optional[ScatterPlan]
    scatter_in: Optional[ScatterPlan]
    prop_out: Optional[PropPlan]
    prop_in: Optional[PropPlan]
    raw_out: Optional[RawEdges]
    raw_in: Optional[RawEdges]
    n: int
    num_workers: int
    n_loc: int
    directed: bool
    name: str
    new_of_old: np.ndarray    # (n,) host relabeling permutation
    device: torch.device
    # partition-derived per-peer capacity bound for edge-derived routed
    # sends (see ChannelContext.edge_capacity; 0 = unknown)
    route_cap: int = 0
    # None: every worker's row of every table (the local backend); an
    # index: this process holds that one worker's row (a rank of a group,
    # Engine(backend="dist")), every table (1, ...) and every static
    # global
    worker: Optional[int] = None

    @property
    def rows(self) -> int:
        """The leading dim of every table: W, or 1 for one worker's
        graph."""
        return self.num_workers if self.worker is None else 1

    @property
    def n_pad(self) -> int:
        return self.num_workers * self.n_loc

    def mine(self, x):
        """``x`` (W, ...) cut to the rows this graph holds."""
        return x if self.worker is None else x[self.worker:self.worker + 1]

    def to_local(self, per_vertex_np) -> torch.Tensor:
        """(n,) old-id host array -> (W, n_loc) device tensor in new-id
        space ((1, n_loc) for one worker's graph)."""
        arr = np.asarray(per_vertex_np)
        out = np.zeros((self.n_pad,) + arr.shape[1:], dtype=arr.dtype)
        out[self.new_of_old] = arr
        return _tensor(self.mine(
            out.reshape((self.num_workers, self.n_loc) + arr.shape[1:])),
            self.device)

    def to_global(self, per_local: torch.Tensor) -> np.ndarray:
        """(W, n_loc, ...) tensor -> (n,) host array in old-id space."""
        flat = per_local.detach().cpu().numpy().reshape(
            (self.n_pad,) + tuple(per_local.shape[2:]))
        return flat[self.new_of_old]

    def global_ids(self) -> torch.Tensor:
        """(W, n_loc) int32 new-space global id of every slot (the rows
        this graph holds)."""
        return self.mine(torch.arange(self.n_pad, dtype=torch.int32,
                                       device=self.device).reshape(
                                           self.num_workers, self.n_loc))


# ---------------------------------------------------------------------------
# host-side (numpy) plan builders — the JAX package's, table for table
# ---------------------------------------------------------------------------


def _build_scatter_plan(
    src_new: np.ndarray,
    dst_new: np.ndarray,
    weights: Optional[np.ndarray],
    n_workers: int,
    n_loc: int,
    align: int = 8,
    mirror_threshold: Optional[int] = None,
) -> Tuple[Dict[str, Any], Dict[str, int]]:
    W = n_workers
    n_pad = W * n_loc
    owner_src = src_new // n_loc
    owner_dst = dst_new // n_loc

    # hub mirroring: a cut edge whose source degree exceeds the threshold
    # is re-homed to the destination owner and reads the hub's value from
    # the extended gather index n_loc + owner(hub) * hub_cap + hub_rank
    home = owner_src
    src_idx = src_new - owner_src * n_loc
    hub_cap = 0
    mirrored = 0
    hub_local_np = None
    if mirror_threshold is not None and len(src_new):
        deg_src = np.bincount(src_new, minlength=n_pad)
        mir = (deg_src[src_new] > mirror_threshold) & (owner_src != owner_dst)
        if mir.any():
            hub_ids = np.unique(src_new[mir])  # sorted => grouped by owner
            hub_owner = hub_ids // n_loc
            per_owner = np.bincount(hub_owner, minlength=W)
            hub_cap = _bucket_cap(int(per_owner.max(initial=0)), align)
            starts = np.concatenate([[0], np.cumsum(per_owner)])[:-1]
            rank_of = np.zeros(n_pad, np.int64)
            rank_of[hub_ids] = np.arange(len(hub_ids)) - starts[hub_owner]
            hub_local_np = np.full((W, hub_cap), n_loc, np.int32)
            for w in range(W):
                mine = hub_ids[hub_owner == w]
                hub_local_np[w, : len(mine)] = (mine - w * n_loc).astype(
                    np.int32)
            home = np.where(mir, owner_dst, owner_src)
            src_idx = np.where(
                mir, n_loc + owner_src * hub_cap + rank_of[src_new], src_idx)
            mirrored = int(mir.sum())

    e_caps, u_caps, c_caps = [], [], []
    per_worker = []
    for w in range(W):
        sel = home == w
        s, d = src_idx[sel], dst_new[sel]
        wt = weights[sel] if weights is not None else None
        order = np.lexsort((s, d))
        s, d = s[order], d[order]
        wt = wt[order] if wt is not None else None
        u, seg = np.unique(d, return_inverse=True) if len(d) else (
            np.zeros(0, np.int64), np.zeros(0, np.int64))
        owners_u = u // n_loc
        cnt = np.bincount(owners_u, minlength=W)
        per_worker.append((s, d, wt, u, seg, owners_u, cnt))
        e_caps.append(len(s))
        u_caps.append(len(u))
        c_caps.append(cnt.max(initial=0))

    e_cap = _bucket_cap(max(e_caps), align)
    u_cap = _bucket_cap(max(u_caps), align)
    c = _bucket_cap(int(max(c_caps)), align)
    _check_int32_extent("scatter_plan/pack_slot (W * slot_cap)", W * c)
    _check_int32_extent(
        "scatter_plan/edge_src (n_loc + W * hub_cap)",
        n_loc + W * hub_cap)

    edge_src = np.zeros((W, e_cap), np.int32)
    edge_seg = np.full((W, e_cap), u_cap, np.int32)
    edge_w = np.zeros((W, e_cap), np.float32) if weights is not None else None
    pack_slot = np.full((W, u_cap), W * c, np.int32)
    recv_local = np.full((W, W, c), n_loc, np.int32)
    send_count = np.zeros((W, W), np.int32)
    remote = 0
    total = 0

    for w in range(W):
        s, d, wt, u, seg, owners_u, cnt = per_worker[w]
        k, e = len(u), len(s)
        total += e
        edge_src[w, :e] = s.astype(np.int32)
        edge_seg[w, :e] = seg.astype(np.int32)
        if edge_w is not None and e:
            edge_w[w, :e] = wt
        starts = np.concatenate([[0], np.cumsum(cnt)])[:-1]  # (W,)
        # u is sorted by global id => grouped by owner, contiguous
        rank = np.arange(k) - starts[owners_u]
        pack_slot[w, :k] = (owners_u * c + rank).astype(np.int32)
        send_count[w] = cnt.astype(np.int32)
        remote += int(cnt.sum() - cnt[w])
        # receive side: peer w sends to owner p its u entries owned by p
        for p in range(W):
            mine = u[owners_u == p]
            recv_local[p, w, : len(mine)] = (mine - p * n_loc).astype(np.int32)

    tables = dict(edge_src=edge_src, edge_seg=edge_seg, edge_w=edge_w,
                  pack_slot=pack_slot, recv_local=recv_local,
                  send_count=send_count, hub_local=hub_local_np)
    statics = dict(n_loc=n_loc, num_workers=W, e_cap=e_cap, u_cap=u_cap,
                   slot_cap=c, remote_entries=remote, total_edges=total,
                   hub_cap=hub_cap, mirrored_edges=mirrored)
    return tables, statics


def _build_prop_plan(src_new, dst_new, weights, n_workers, n_loc, align=8,
                     mirror_threshold=None):
    W = n_workers
    owner_s = src_new // n_loc
    internal = owner_s == dst_new // n_loc

    # internal CSR (per worker, sorted by (local dst, local src))
    per_worker = []
    for w in range(W):
        sel = internal & (owner_s == w)
        s = (src_new[sel] - w * n_loc).astype(np.int32)
        d = (dst_new[sel] - w * n_loc).astype(np.int32)
        wt = weights[sel] if weights is not None else None
        order = np.lexsort((s, d))
        per_worker.append((s[order], d[order],
                           wt[order] if wt is not None else None))
    ei_cap = _bucket_cap(max(len(s) for s, _, _ in per_worker), align)
    int_src = np.zeros((W, ei_cap), np.int32)
    int_dst = np.full((W, ei_cap), n_loc, np.int32)
    int_w = np.zeros((W, ei_cap), np.float32) if weights is not None else None
    for w, (s, d, wt) in enumerate(per_worker):
        int_src[w, : len(s)] = s
        int_dst[w, : len(d)] = d
        if int_w is not None and len(s):
            int_w[w, : len(s)] = wt

    cut = ~internal
    cut_tables, cut_statics = _build_scatter_plan(
        src_new[cut], dst_new[cut],
        weights[cut] if weights is not None else None,
        n_workers, n_loc, align, mirror_threshold=mirror_threshold)
    tables = dict(int_src=int_src, int_dst=int_dst, int_w=int_w,
                  cut=cut_tables)
    return tables, dict(ei_cap=ei_cap, cut=cut_statics)


def _build_raw_edges(src_new, dst_new, weights, n_workers, n_loc, align=8):
    W = n_workers
    owner = src_new // n_loc
    counts = [int((owner == w).sum()) for w in range(W)]
    e_cap = _bucket_cap(max(counts, default=0), align)
    src_l = np.zeros((W, e_cap), np.int32)
    dst_g = np.zeros((W, e_cap), np.int32)
    ws = np.zeros((W, e_cap), np.float32) if weights is not None else None
    mask = np.zeros((W, e_cap), bool)
    for w in range(W):
        sel = owner == w
        e = int(sel.sum())
        src_l[w, :e] = (src_new[sel] - w * n_loc).astype(np.int32)
        dst_g[w, :e] = dst_new[sel].astype(np.int32)
        if ws is not None and e:
            ws[w, :e] = weights[sel]
        mask[w, :e] = True
    tables = dict(src_local=src_l, dst_global=dst_g, w=ws, mask=mask)
    return tables, dict(e_cap=e_cap)


def validate_edge_list(g) -> None:
    """Reject graphs whose edges index outside ``[0, n)`` or whose
    weights are NaN/inf, with the offending positions in the message."""
    if g.n < 1:
        raise ValueError(f"graph must have at least one vertex, got n={g.n}")
    e = np.asarray(g.edges)
    if e.size:
        if e.ndim != 2 or e.shape[1] != 2:
            raise ValueError(
                f"edges must be (E, 2) (src, dst), got shape {e.shape}")
        bad = (e < 0) | (e >= g.n)
        if bad.any():
            rows = np.flatnonzero(bad.any(axis=1))[:5]
            raise ValueError(
                f"{int(bad.any(axis=1).sum())} edge endpoint(s) outside "
                f"[0, {g.n}) — first bad edges at rows {rows.tolist()}: "
                f"{e[rows].tolist()}")
    if g.weights is not None:
        w = np.asarray(g.weights)
        if w.shape[0] != e.shape[0]:
            raise ValueError(
                f"weights length {w.shape[0]} != num edges {e.shape[0]}")
        nonfinite = ~np.isfinite(w)
        if nonfinite.any():
            rows = np.flatnonzero(nonfinite)[:5]
            raise ValueError(
                f"{int(nonfinite.sum())} non-finite edge weight(s) "
                f"(NaN/inf) — first at rows {rows.tolist()}: "
                f"{w[rows].tolist()}")


def _route_cap_bound(src, dst, n_workers: int, n_loc: int) -> int:
    """Max over (sending worker, owner) pairs of the number of *unique*
    destinations — the provable per-peer occupancy bound for any deduping
    routed send whose destinations are edge endpoints."""
    if not len(src):
        return 0
    n_pad = n_workers * n_loc
    key = (src // n_loc).astype(np.int64) * n_pad + dst
    u = np.unique(key)
    pair = (u // n_pad) * n_workers + (u % n_pad) // n_loc
    return int(np.bincount(pair, minlength=n_workers * n_workers).max())


def resolve_mirror_threshold(g: EdgeList, mirror_threshold) -> Optional[int]:
    """``None`` -> no mirroring; ``"auto"`` -> a degree several times the
    mean; an int passes through."""
    if mirror_threshold is None:
        return None
    if mirror_threshold == "auto":
        avg = len(g.edges) / max(g.n, 1)
        return max(64, int(8 * avg))
    return int(mirror_threshold)


# ---------------------------------------------------------------------------
# device graphs
# ---------------------------------------------------------------------------


def _scatter_from_arrays(tables, statics, device) -> ScatterPlan:
    extra = set(tables) | set(statics)
    known = {f.name for f in dataclasses.fields(ScatterPlan)} | set(_TPU_ONLY)
    if extra - known:
        raise ValueError(f"unknown ScatterPlan fields {sorted(extra - known)}")
    recv = np.asarray(tables["recv_local"])
    flat = recv.reshape(recv.shape[0], -1)
    order = np.argsort(flat, axis=1, kind="stable").astype(np.int32)
    return ScatterPlan(
        **{k: _tensor(tables.get(k), device)
           for k in ("edge_src", "edge_seg", "edge_w", "pack_slot",
                     "recv_local", "send_count", "hub_local")},
        recv_order=_tensor(order, device),
        recv_sorted=_tensor(np.take_along_axis(flat, order, axis=1), device),
        **{k: int(statics[k])
           for k in ("n_loc", "num_workers", "e_cap", "u_cap", "slot_cap",
                     "remote_entries", "total_edges", "hub_cap",
                     "mirrored_edges")},
    )


def _prop_from_arrays(tables, statics, device) -> PropPlan:
    extra = (set(tables) | set(statics)) - {
        f.name for f in dataclasses.fields(PropPlan)}
    if extra:
        raise ValueError(f"unknown PropPlan fields {sorted(extra)}")
    return PropPlan(
        **{k: _tensor(tables.get(k), device)
           for k in ("int_src", "int_dst", "int_w")},
        cut=_scatter_from_arrays(tables["cut"], statics["cut"], device),
        ei_cap=int(statics["ei_cap"]))


def _raw_from_arrays(tables, statics, device) -> RawEdges:
    return RawEdges(**{k: _tensor(tables.get(k), device)
                       for k in ("src_local", "dst_global", "w", "mask")},
                    e_cap=int(statics["e_cap"]))


_FROM_ARRAYS = {"scatter": _scatter_from_arrays, "prop": _prop_from_arrays,
                "raw": _raw_from_arrays}


def _row_of(tables, worker: int):
    """Every per-worker table of ``tables`` (nested plan dicts included)
    cut to row ``worker``, as a (1, ...) array."""
    out = {}
    for k, v in tables.items():
        if isinstance(v, dict):
            out[k] = _row_of(v, worker)
        elif v is None:
            out[k] = None
        else:
            out[k] = np.asarray(v)[worker:worker + 1]
    return out


def from_arrays(tables: Dict[str, Any], statics: Dict[str, Any],
                device=None, worker: Optional[int] = None
                ) -> PartitionedGraph:
    """Build the port's graph from host arrays — the port's own plans, or
    the JAX package's ``PartitionedGraph`` leaves handed over as numpy
    (the tests feed both packages the identical plan this way).

    Args:
      tables: ``{"v_mask", "deg_out"}`` arrays plus, per built plan in
        ``PLANS``, a dict of its tables (absent or None = not built); a
        PropPlan's cut ScatterPlan is a dict nested under ``"cut"``. The
        JAX ScatterPlan's TPU tiling tables are accepted and ignored.
      statics: ``n``, ``num_workers``, ``n_loc``, ``directed``, ``name``,
        ``new_of_old`` (host array), ``route_cap``, and per built plan a
        dict of its static ints (a PropPlan's cut ones nested under
        ``"cut"``).
      device: target device (None = CUDA; raises without it).
      worker: None for every worker's rows (the local backend), or the
        index of the one worker whose rows go to ``device`` (a rank of a
        group): every table becomes ``(1, ...)``, the statics stay global.
    """
    device = resolve_device(device)
    if worker is not None:
        if not 0 <= worker < int(statics["num_workers"]):
            raise ValueError(f"worker {worker} of a graph of "
                             f"{statics['num_workers']} workers")
        tables = _row_of(tables, worker)
    plans = {}
    for p in PLANS:
        if tables.get(p) is None:
            plans[p] = None
        else:
            plans[p] = _FROM_ARRAYS[p.split("_")[0]](tables[p], statics[p],
                                                     device)
    return PartitionedGraph(
        v_mask=_tensor(np.asarray(tables["v_mask"], bool), device),
        deg_out=_tensor(np.asarray(tables["deg_out"], np.int32), device),
        **plans,
        n=int(statics["n"]),
        num_workers=int(statics["num_workers"]),
        n_loc=int(statics["n_loc"]),
        directed=bool(statics["directed"]),
        name=str(statics["name"]),
        new_of_old=np.asarray(statics["new_of_old"]),
        device=device,
        route_cap=int(statics["route_cap"]),
        worker=worker,
    )


def partition_tables(
    g: EdgeList,
    n_workers: int,
    partitioner: str = "random",
    seed: int = 0,
    build=("scatter_out",),
    align: int = 8,
    mirror_threshold=None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The host half of :func:`partition_graph`: ``(tables, statics)``
    in the form :func:`from_arrays` takes."""
    validate_edge_list(g)
    if partitioner not in partition_lib.PARTITIONERS:
        raise ValueError(
            f"unknown partitioner {partitioner!r}; known partitioners: "
            f"{sorted(partition_lib.PARTITIONERS)}")
    for p in build:
        if p not in PLANS:
            raise ValueError(f"unknown plan {p!r}; known: {PLANS}")
    new_of_old = partition_lib.PARTITIONERS[partitioner](g, n_workers, seed)
    n_loc = _round_up(-(-g.n // n_workers), align)
    src = new_of_old[g.edges[:, 0]]
    dst = new_of_old[g.edges[:, 1]]
    w = g.weights
    thr = resolve_mirror_threshold(g, mirror_threshold)

    W = n_workers
    _check_int32_extent("partition (W * n_loc)", W * n_loc)
    v_mask = np.zeros((W, n_loc), bool)
    v_mask.reshape(-1)[np.asarray(new_of_old)] = True
    deg = np.zeros(W * n_loc, np.int32)
    np.add.at(deg, src, 1)

    tables: Dict[str, Any] = {"v_mask": v_mask,
                              "deg_out": deg.reshape(W, n_loc)}
    route_cap = max(_route_cap_bound(src, dst, W, n_loc),
                    _route_cap_bound(dst, src, W, n_loc))
    statics: Dict[str, Any] = dict(
        n=g.n, num_workers=W, n_loc=n_loc, directed=g.directed, name=g.name,
        new_of_old=new_of_old,
        route_cap=_bucket_cap(route_cap, align) if route_cap else 0)
    builders = {
        "scatter_out": lambda: _build_scatter_plan(
            src, dst, w, W, n_loc, align, mirror_threshold=thr),
        "scatter_in": lambda: _build_scatter_plan(
            dst, src, w, W, n_loc, align, mirror_threshold=thr),
        "prop_out": lambda: _build_prop_plan(
            src, dst, w, W, n_loc, align, mirror_threshold=thr),
        "prop_in": lambda: _build_prop_plan(
            dst, src, w, W, n_loc, align, mirror_threshold=thr),
        "raw_out": lambda: _build_raw_edges(src, dst, w, W, n_loc, align),
        "raw_in": lambda: _build_raw_edges(dst, src, w, W, n_loc, align),
    }
    for p in PLANS:
        if p in build:
            tables[p], statics[p] = builders[p]()
    return tables, statics


def partition_graph(
    g: EdgeList,
    n_workers: int,
    partitioner: str = "random",
    seed: int = 0,
    build=("scatter_out",),
    align: int = 8,
    mirror_threshold=None,
    device=None,
    worker: Optional[int] = None,
) -> PartitionedGraph:
    """Partition + relabel a graph, precompute the requested plans on the
    host and move them to ``device`` once (None = CUDA; raises without
    it).

    build: subset of ``PLANS`` (scatter, propagation and raw-edge plans,
    each in the ``_out`` and ``_in`` orientation).
    mirror_threshold: hub mirroring in the scatter and propagation-cut
    plans — ``None`` (off),
    an int degree threshold, or ``"auto"`` (see the JAX package's
    ``partition_graph``).
    worker: None, or the one worker whose rows go to ``device`` (a rank
    of ``Engine(backend="dist")``; see :func:`from_arrays`).
    """
    device = resolve_device(device)
    tables, statics = partition_tables(
        g, n_workers, partitioner, seed, build, align, mirror_threshold)
    return from_arrays(tables, statics, device, worker=worker)
