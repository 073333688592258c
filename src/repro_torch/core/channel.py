"""Channel base machinery: per-step context, registry, message accounting
(paper §IV — the channel interface every §IV-C optimization implements).

The port of ``repro.core.channel``. A channel is a plain function over
``(W, ...)`` tensors — every worker's shard at once — and the
``ChannelContext`` carries the worker count, the per-worker vertex width
and the per-channel traffic statistics: logical bytes and message counts
that cross worker boundaries, one int32 counter per worker (stat leaves
of shape ``(W,)``, as the JAX package's ``vmap`` surfaces them).

On a rank of a ``torch.distributed`` group (``Engine(backend="dist")``)
the leading dim holds that one worker's row: ``ChannelContext.rows`` is
1 while ``num_workers`` stays W, the peer count of every exchange, and
the context's ``workers`` layer (``repro_torch.distributed.workers``)
turns each cross-worker step into a collective.

Per-step counters are ``TRAFFIC_DTYPE`` (int32) on the device and wrap
like the JAX ones; the host-driven loop accumulates them across
supersteps in Python ints and raises ``TrafficWrapError`` on a negative
per-step delta.

A loop inside a superstep (pointer jumping, label propagation, the
Propagation channel's fixpoints) is an :func:`inner_loop`: a Python loop
in host mode, a WHILE node of the captured graph in the fused and
chunked modes, as the JAX package's ``lax.while_loop``.

Under the batched query plane (``num_queries=Q``) the context also
carries the query axis: every state leaf is ``(W, Q, n_loc, ...)``, the
``(Q,)`` pre-step liveness ``query_live`` tells the routed channels which
lanes may send, and every stat and overflow leaf is ``(W, Q)`` — per
worker and per lane — so ``add_traffic``/``add_overflow`` take ``(W, Q)``
deltas (or a scalar, broadcast).
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch import tracing
from repro_torch.distributed import workers as workers_lib

TRAFFIC_DTYPE = torch.int32


def on_device(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as a ``dtype`` tensor on ``device``. A Python number becomes a
    fill on the device, never a copy from host memory, which a stream
    that captures a CUDA graph refuses; an integer wraps into ``dtype``'s
    range as a host tensor cast would. Tensors and arrays are cast and
    moved."""
    if isinstance(x, (bool, int, float)):
        if dtype == torch.bool:
            x = bool(x)
        elif not dtype.is_floating_point:
            bits = torch.iinfo(dtype).bits
            x = (int(x) + (1 << (bits - 1))) % (1 << bits) - (1 << (bits - 1))
        return torch.full((), x, dtype=dtype, device=device)
    return torch.as_tensor(x, device=device).to(dtype)


@dataclasses.dataclass(frozen=True)
class DeviceLoopHooks:
    """What the runtime's device loop (``fused``/``chunked``) lends the
    steps it runs, for their inner loops (:func:`inner_loop`).

    read: reads a 0-d flag back to the host outside the loop's host-sync
      guard — how an eager inner loop (the CPU, or the warm-up step on
      the card) decides whether to go on.
    nest: while the card captures the loop, the body streams of its
      conditional nodes (``kernels.graph_if.Nest``); None when the step
      runs eagerly.
    """

    read: Callable[[torch.Tensor], bool]
    nest: Any = None


def _as_carry(x, device: torch.device) -> torch.Tensor:
    """A carry element as a device tensor: a Python bool becomes a bool,
    an int an int32 counter (the JAX ``while_loop``'s), a tensor itself."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, bool):
        return on_device(x, device, torch.bool)
    if isinstance(x, int):
        return on_device(x, device, torch.int32)
    raise TypeError(f"a loop's carry holds tensors, bools and ints, not "
                    f"{type(x).__name__}")


def store(bufs: Sequence[torch.Tensor], new: Sequence) -> None:
    """``new`` into the buffers ``bufs``, element by element, in place:
    shapes and dtypes must match (a loop on the device keeps a fixed
    layout). A value that shares storage with a buffer is cloned first, so
    no copy reads a buffer another copy has already written."""
    new = tuple(new)
    if len(new) != len(bufs):
        raise ValueError(f"a loop's carry has {len(bufs)} elements, its "
                         f"body returned {len(new)}")
    pending = []
    for buf, v in zip(bufs, new):
        if v is buf:
            continue
        if not isinstance(v, torch.Tensor):
            v = on_device(v, buf.device, buf.dtype)
        elif v.shape != buf.shape or v.dtype != buf.dtype:
            raise ValueError(
                f"a loop's body changes a carry element from {buf.dtype} "
                f"{tuple(buf.shape)} to {v.dtype} {tuple(v.shape)}; a loop "
                "on the device needs a fixed layout")
        elif any(v.untyped_storage().data_ptr()
                 == b.untyped_storage().data_ptr() for b in bufs):
            v = v.clone()
        pending.append((buf, v))
    for buf, v in pending:
        buf.copy_(v)


def inner_loop(ctx: "ChannelContext", cond: Callable, body: Callable,
               carry: Sequence, name: str = "loop") -> tuple:
    """``while cond(carry): carry = body(carry)`` — the port of the JAX
    package's ``lax.while_loop`` for a loop inside a superstep. ``carry``
    is a tuple of tensors (and, in host mode, Python numbers); ``cond``
    gives a 0-d bool tensor (or a Python bool) from it, ``body`` the next
    carry. Returns the last carry.

    ``name`` names the loop's site for ``repro_torch.tracing``: each run
    of the body is an ``inner:<name>`` device span (inside the WHILE
    body when the card captures).

      - host mode (``ctx.device_loop`` unset): a Python loop, one
        readback of ``cond`` an iteration; Python numbers stay Python
        numbers.
      - a device loop that runs eagerly (the CPU, or the warm-up step on
        the card): the carry becomes device tensors (an int an int32
        counter), copied into buffers; ``cond`` is read outside the
        host-sync guard, and ``body`` runs under it and writes its carry
        back into the buffers.
      - a device loop that the card captures: the same buffers, made
        before the node, and a WHILE node of the captured graph
        (``kernels.graph_if``) whose body is ``body`` captured once; its
        condition, ``cond`` of the buffers, is read on the device when
        the graph reaches the node and after each run of the body.
    """
    hooks = ctx.device_loop
    carry = tuple(carry)
    site = "inner:" + name
    if hooks is None:
        while bool(cond(carry)):
            with tracing.device_span(site, ctx.device):
                carry = tuple(body(carry))
        return carry
    bufs = tuple(_as_carry(x, ctx.device).clone() for x in carry)

    def go():
        flag = cond(bufs)
        if not (isinstance(flag, torch.Tensor) and flag.dtype == torch.bool
                and flag.numel() == 1):
            raise TypeError("a loop on the device takes a one-element bool "
                            f"tensor as its condition, got {flag!r}")
        return flag.reshape(())

    if hooks.nest is None:
        while hooks.read(go()):
            with tracing.device_span(site, ctx.device):
                store(bufs, body(bufs))
        return bufs
    pred = go().clone()
    with hooks.nest.while_node(pred):
        with tracing.device_span(site, ctx.device):
            store(bufs, body(bufs))
        pred.copy_(go())
    return bufs


def channel_span(ctx: "ChannelContext", *names: str):
    """The ``channel:<full names, joined by +>`` device span of a channel
    call (``repro_torch.tracing``); a no-op when nothing records."""
    if tracing.active() is None:
        return tracing.NULL
    full = "+".join(ctx.full_name(n) for n in names)
    return tracing.device_span("channel:" + full, ctx.device)


def traced_channel(fn: Callable) -> Callable:
    """A channel entry point each of whose calls is a :func:`channel_span`
    named by its ``name`` keyword (or that keyword's default)."""
    default = inspect.signature(fn).parameters["name"].default

    @functools.wraps(fn)
    def call(ctx, *args, **kw):
        with channel_span(ctx, kw.get("name", default)):
            return fn(ctx, *args, **kw)

    return call


def key_under(key: str, prefix: str) -> bool:
    """Whether a "/"-namespaced stat key belongs to ``prefix`` (exact
    match or nested below it) — the namespace convention of the
    composition layer (``repro_torch.core.compose``)."""
    return key == prefix or key.startswith(prefix + "/")


@dataclasses.dataclass(frozen=True)
class ChannelRegistry:
    """A declared, fixed set of channel stat keys. In host mode it only
    seeds zero stats for every declared key and rejects undeclared ones."""

    names: Tuple[str, ...]

    @classmethod
    def declare(cls, names) -> "ChannelRegistry":
        return cls(names=tuple(sorted(names)))


@dataclasses.dataclass
class ChannelContext:
    num_workers: int
    n_loc: int
    device: torch.device
    registry: Optional[ChannelRegistry] = None
    stats_bytes: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    stats_msgs: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # per-channel overflow latches (bool (W,)), same key set as the
    # traffic stats
    stats_ovf: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    # capacity-scale overrides keyed by channel name (or the "*"
    # wildcard); see scale_capacity()
    cap_scales: Dict[str, float] = dataclasses.field(default_factory=dict)
    # namespace prefix composed by the composition layer's child contexts,
    # so scale_capacity sees the same full names the registry records
    name_prefix: str = ""
    # names that actually reached add_traffic
    touched: set = dataclasses.field(default_factory=set)
    # partition-derived per-peer capacity bound for edge-derived routed
    # sends (PartitionedGraph.route_cap; 0 = unknown). See edge_capacity().
    route_cap: int = 0
    # batched query plane: the lane count Q (None on a solo run) and each
    # lane's pre-step liveness, a (Q,) bool tensor (None = all live)
    num_queries: Optional[int] = None
    query_live: Optional[torch.Tensor] = None
    # set by the fused and chunked modes: the step runs inside a loop on
    # the device (a CUDA graph on the card), and its inner loops
    # (inner_loop) run there too
    device_loop: Optional[DeviceLoopHooks] = None
    # the cross-worker operations (repro_torch.distributed.workers): all
    # W workers in this process (None: LocalWorkers), or one a rank of a
    # torch.distributed group
    workers: Any = None

    def __post_init__(self):
        self.workers = workers_lib.resolve(self.workers, self.num_workers)
        if self.workers.size != self.num_workers:
            raise ValueError(
                f"a context of {self.num_workers} workers over a workers "
                f"layer of {self.workers.size}")
        if self.registry is not None:
            for n in self.registry.names:
                self.stats_bytes.setdefault(n, self._zeros())
                self.stats_msgs.setdefault(n, self._zeros())
                self.stats_ovf.setdefault(n, self._zeros(torch.bool))

    @property
    def batched(self) -> bool:
        """True when this step runs under the batched query plane."""
        return self.num_queries is not None

    @property
    def rows(self) -> int:
        """The leading dim of every tensor of the step: W when all
        workers run in this process, 1 on a rank of a group. The peer
        count (every exchange buffer's second dim) stays
        ``num_workers``."""
        return self.workers.rows

    @property
    def stat_shape(self) -> Tuple[int, ...]:
        """``(rows,)``, or ``(rows, Q)`` under the batched query plane."""
        if self.batched:
            return (self.rows, self.num_queries)
        return (self.rows,)

    def _zeros(self, dtype=TRAFFIC_DTYPE) -> torch.Tensor:
        return torch.zeros(self.stat_shape, dtype=dtype, device=self.device)

    def _per_worker(self, x, dtype) -> torch.Tensor:
        return on_device(x, self.device, dtype).expand(self.stat_shape)

    def me(self) -> torch.Tensor:
        """(rows,) worker index of each row — the port of
        ``axis_index``."""
        return self.workers.me(self.device)

    def query_index(self) -> torch.Tensor:
        """(Q,) lane index — what the JAX package's per-lane
        ``query_index`` holds under its query ``vmap``."""
        return torch.arange(self.num_queries, device=self.device)

    def add_traffic(self, name: str, nbytes, nmsgs):
        """Add per-worker byte and message counts under ``name``: ``(W,)``
        deltas, ``(W, Q)`` under the batched query plane, or a scalar
        (broadcast)."""
        self.touched.add(name)
        if self.registry is not None and name not in self.registry.names:
            raise KeyError(
                f"channel {name!r} is not in the registry "
                f"{self.registry.names}")
        self.stats_bytes[name] = self.stats_bytes.get(
            name, self._zeros()) + self._per_worker(nbytes, TRAFFIC_DTYPE)
        self.stats_msgs[name] = self.stats_msgs.get(
            name, self._zeros()) + self._per_worker(nmsgs, TRAFFIC_DTYPE)

    def add_overflow(self, name: str, flag):
        """Latch a channel's per-worker (per-lane, when batched) overflow
        flag under its stat key."""
        prev = self.stats_ovf.get(name, self._zeros(torch.bool))
        self.stats_ovf[name] = prev | self._per_worker(flag, torch.bool)

    def edge_capacity(self, default: int) -> int:
        """Per-peer slot capacity for a deduping routed send whose
        destinations are graph edge endpoints: the partition's
        ``route_cap`` bound, never above ``default`` (see the JAX
        package's ``ChannelContext.edge_capacity`` for the proof)."""
        return min(self.route_cap, default) if self.route_cap else default

    def full_name(self, name: str) -> str:
        """``name`` qualified by the composition-layer namespace prefix —
        the key the registry sees."""
        return f"{self.name_prefix}/{name}" if self.name_prefix else name

    def scale_capacity(self, name: str, capacity: int) -> int:
        """Apply a capacity-scale override for this channel (its full
        name beats the "*" wildcard; absent/1.0 leaves it unchanged).
        Scaled caps re-bucket to the next power of two."""
        scale = self.cap_scales.get(
            self.full_name(name), self.cap_scales.get("*", 1.0))
        if not self.cap_scales or scale == 1.0:
            return capacity
        scaled = max(1, int(capacity * scale))
        return 1 << (scaled - 1).bit_length()

    def stats(self) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        return dict(self.stats_bytes), dict(self.stats_msgs)


def payload_width(payload: Dict[str, torch.Tensor],
                  batched: bool = False) -> int:
    """Total bytes per message for a dict payload of ``(W, M, ...)``
    leaves (``(W, Q, M, ...)`` when ``batched``)."""
    total = 0
    for leaf in payload.values():
        per = 1
        for d in leaf.shape[3 if batched else 2:]:
            per *= d
        total += per * leaf.element_size()
    return total
