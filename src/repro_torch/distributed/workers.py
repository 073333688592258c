"""The cross-worker operations of the step code — the port of the JAX
package's axis-name collectives (``axis_index``, the tiled
``all_to_all``, ``psum``/``pmin``/``pmax``/``psum_like``,
``all_gather``).

Every tensor of a step has a leading worker dim. The step code tells
two numbers apart: the **peer count** ``size`` (W, the second dim of
every exchange buffer, the same on both backends) and the **rows**
``rows``, the leading dim of the tensors this process holds. Each
operation below has one definition and two implementations:

  - :class:`LocalWorkers` (``Engine(backend="local")``, the JAX
    ``"vmap"`` backend): all W workers in one process, ``rows == W``;
    a collective is a transpose or a fold over dim 0.
  - :class:`GroupWorkers` (``Engine(backend="dist")``, the JAX
    ``"shard_map"`` backend): one worker a process of a
    ``torch.distributed`` group of size W, ``rows == 1``; a collective is
    a ``torch.distributed`` call.

The two are bit-identical: an order-sensitive reduction (a float
``sum``, ``prod``, ``min_by_first``) gathers every worker's rows and
folds them in index order, as the local fold does, rather than trust a
ring all-reduce's order. Every reduction gathers, so NaN and infinities
meet the same ``amin``/``amax`` as locally; only the bool votes use
``all_reduce``, which is exact on integers.

:class:`GroupWorkers` counts what crosses the process boundary
(``collectives``, ``bytes``: the bytes this rank sends a call), so a run
can report its collectives a superstep. Its collectives are the list
forms of ``torch.distributed`` (``all_to_all_single``, ``all_gather``,
``all_reduce``, ``broadcast_object_list``), which the device loops'
host-sync guard lets through: on a group those loops run eagerly, never
captured (``repro_torch.pregel.runtime``), and each rank issues the same
collectives in the same order. ``gather_host`` is the loops' readback
(a host-mode superstep, a chunk boundary), ``broadcast`` the group's one
decision (rank 0's ``Plan`` under ``plan="auto"``).
"""
from __future__ import annotations

from typing import List, Optional

import torch


def fold_workers(x: torch.Tensor, combiner) -> torch.Tensor:
    """``combiner`` over dim 0 of ``x`` (W, ...) to ``(1, ...)``:
    ``min``/``max``/``or`` as library reductions (exact in any order),
    ``sum``, ``prod`` and ``min_by_first`` folded in index order, as the
    JAX ``psum_like`` folds its ``all_gather`` — elementwise ops, so each
    trailing entry rounds the same whatever the other dims hold (a
    batched lane as its solo run)."""
    name = combiner.name
    if name == "min":
        return x.amin(0, keepdim=True)
    if name == "max":
        return x.amax(0, keepdim=True)
    if name == "or":
        return x.any(0, keepdim=True)
    red = x[0]
    for i in range(1, x.shape[0]):
        red = combiner.fn(red, x[i])
    return red[None]


class LocalWorkers:
    """All W workers in this process: every tensor's leading dim is W."""

    distributed = False

    def __init__(self, size: int):
        self.size = int(size)

    @property
    def rows(self) -> int:
        return self.size

    def me(self, device) -> torch.Tensor:
        """(W,) worker index of each row — ``axis_index``."""
        return torch.arange(self.size, device=device)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """Each row's entry for itself as a peer: ``x[r, me[r]]`` of a
        ``(rows, W, ...)`` tensor (the diagonal of a local one)."""
        idx = self.me(x.device)
        return x[torch.arange(x.shape[0], device=x.device), idx]

    def exchange(self, buf: torch.Tensor, peer_dim: int = 1) -> torch.Tensor:
        """The tiled ``all_to_all``: worker q's block for peer p becomes
        worker p's block from peer q — ``(W_src, ..., W_dst, ...)`` to
        ``(W_dst, ..., W_src, ...)``, the peer dim at ``peer_dim``."""
        return buf.transpose(0, peer_dim).contiguous()

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every worker's rows, ``(W, ...)`` — ``all_gather``."""
        return x

    def reduce(self, x: torch.Tensor, combiner) -> torch.Tensor:
        """``combiner`` across the workers (dim 0), broadcast back to
        every row — ``psum``/``pmin``/``pmax``/``psum_like``."""
        return fold_workers(self.gather(x), combiner).expand(
            (self.rows,) + tuple(x.shape[1:]))

    def any(self, flag) -> torch.Tensor:
        """0-d bool: any entry of ``flag`` on any worker."""
        return torch.as_tensor(flag).any()

    def all(self, flag) -> torch.Tensor:
        """0-d bool: every entry of ``flag`` on every worker."""
        return torch.as_tensor(flag).all()

    def gather_host(self, flat: torch.Tensor) -> torch.Tensor:
        """``(R, L)`` host rows of a flat row, one a process: the one
        readback a host-mode superstep makes."""
        return flat.cpu()[None]


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous tensor the transport takes: bools ride as
    uint8."""
    x = x.contiguous()
    return x.to(torch.uint8) if x.dtype == torch.bool else x


class GroupWorkers:
    """One worker a process of ``group``: every tensor's leading dim is 1
    and the worker is the process's rank in the group."""

    distributed = True

    def __init__(self, group=None):
        import torch.distributed as dist

        self.dist = dist
        self.group = dist.group.WORLD if group is None else group
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = str(dist.get_backend(self.group))
        self.collectives = 0
        self.bytes = 0

    rows = 1

    def _count(self, *xs: torch.Tensor) -> None:
        self.collectives += 1
        self.bytes += sum(x.numel() * x.element_size() for x in xs)

    def me(self, device) -> torch.Tensor:
        return torch.full((1,), self.rank, dtype=torch.int64, device=device)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, self.rank]

    def exchange(self, buf: torch.Tensor, peer_dim: int = 1) -> torch.Tensor:
        """One ``all_to_all_single`` on the peer dim, made the leading
        one: ``(1, ..., W_dst, ...)`` to ``(1, ..., W_src, ...)``."""
        send = _wire(buf.movedim(peer_dim, 0))
        recv = torch.empty_like(send)
        self._count(send)
        self.dist.all_to_all_single(recv, send, group=self.group)
        return recv.to(buf.dtype).movedim(0, peer_dim)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(1, ...)`` rows, ``(W, ...)`` in rank order (the
        list form of ``all_gather``, which every torch release has)."""
        send = _wire(x)
        parts: List[torch.Tensor] = [torch.empty_like(send)
                                     for _ in range(self.size)]
        self._count(send)
        self.dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts).to(x.dtype)

    def reduce(self, x: torch.Tensor, combiner) -> torch.Tensor:
        return fold_workers(self.gather(x), combiner)

    def _vote(self, mine: torch.Tensor, op) -> torch.Tensor:
        """``op`` of every rank's 0-d bool ``mine``: an exact
        ``all_reduce`` of one int32."""
        v = mine.to(torch.int32).reshape(1)
        self._count(v)
        self.dist.all_reduce(v, op=op, group=self.group)
        return v[0] != 0

    def any(self, flag) -> torch.Tensor:
        return self._vote(torch.as_tensor(flag).any(),
                          self.dist.ReduceOp.MAX)

    def all(self, flag) -> torch.Tensor:
        return self._vote(torch.as_tensor(flag).all(),
                          self.dist.ReduceOp.MIN)

    def gather_host(self, flat: torch.Tensor) -> torch.Tensor:
        """Every rank's flat row, ``(W, L)`` on the host: one
        ``all_gather`` of the row where the group's transport keeps it (a
        host tensor for gloo, a device tensor for NCCL)."""
        if self.backend != "nccl":
            flat = flat.cpu()
        return self.gather(flat[None]).cpu()

    def broadcast(self, obj):
        """Rank 0's ``obj`` on every rank (``broadcast_object_list``; what
        the other ranks pass is ignored): one decision for the group, such
        as rank 0's ``Plan``."""
        box = [obj]
        self.collectives += 1
        self.dist.broadcast_object_list(
            box, src=self.dist.get_global_rank(self.group, 0),
            group=self.group)
        return box[0]


def resolve(workers: Optional[object], size: int):
    """``workers``, or the local backend of ``size`` workers."""
    return LocalWorkers(size) if workers is None else workers
