"""The planner: abstract channel declarations -> one concrete ``Plan``
(the port of ``repro.plan.planner``).

A program declares *what* its channels do (the registry's
``channel_class``, the graph plans it needs); the planner decides *how*
each declaration is lowered: a :class:`Plan`, the full knob assignment
``(mode, chunk_size, use_kernel, route_impl, route_batch,
dense_threshold)`` plus one :class:`Decision` record per knob with the
candidate costs that justified it. ``Engine(plan="auto")`` resolves a
Plan per (program, graph shape, Q) before it builds a loop, folds
:meth:`Plan.key` into the key of its cached loops, and stamps the Plan on
``RunResult.plan``; ``python -m repro_torch plan --explain`` prints the
decision table. Plans and their JSON have the JAX package's layout, so a
plan either package wrote loads in the other.

Guarantees:

- **Determinism**: equal fingerprints give equal plans, across
  processes, the probe cache warm or cold. The JAX planner states this
  for probe margins of "~2x" and does not check them; the port does: a
  decision follows the measured probe only when its winner is at least
  :data:`PROBE_MARGIN` times faster, else the corpus fit decides. The
  density threshold is fitted from the committed corpus alone.
- **One legal value on the card**: on a ``"cuda"`` fingerprint
  ``use_kernel`` is ``True`` and ``route_impl`` is ``"bucket"`` — the
  port has no plain path and no sort baseline on a CUDA tensor — and
  ``dense_threshold`` is the knob default, since the corpus holds CPU
  curves only (``CostModel.dense_threshold``). The probes decide nothing
  there, so a card plan times them only to be explained
  (``Planner(explain=True)``, ``plan --explain``), which fills the
  measured column with the card's margin.
- **On the CPU** every candidate of ``use_kernel`` and ``route_impl``
  is a plain PyTorch path with the same output: the engine records the
  planner's choice and runs the port's one CPU path.
- **Explicit wins**: a knob the caller set is taken verbatim and
  recorded with source ``"explicit"``.
- **Bit-identity**: a Plan selects only among implementations already
  held output-identical (the routed exchange's two rank
  implementations, each kernel against its plain version), so a planned
  run equals the hand-set run with the same knobs bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.plan import cost_model as cm
from repro_torch.plan import features

KNOBS = ("mode", "chunk_size", "use_kernel", "route_impl", "route_batch",
         "dense_threshold")

#: how much faster the measured winner must be for a probe to decide
#: (below it, two cold processes' noise could reverse the choice)
PROBE_MARGIN = 1.5


@dataclasses.dataclass(frozen=True)
class Decision:
    """One planned knob: what was chosen, on what evidence.

    candidates: ``(name, predicted_s, measured_s)`` tuples (a cost is
    None where a source had no evidence for that candidate).
    """

    knob: str
    chosen: Any
    source: str = "planner"   # "planner" | "explicit" | "default"
    candidates: Tuple[Tuple[str, Optional[float], Optional[float]], ...] = ()
    reason: str = ""

    def to_json(self) -> dict:
        return {"knob": self.knob, "chosen": self.chosen,
                "source": self.source,
                "candidates": [list(c) for c in self.candidates],
                "reason": self.reason}

    @classmethod
    def from_json(cls, data: dict) -> "Decision":
        return cls(knob=data["knob"], chosen=data["chosen"],
                   source=data["source"],
                   candidates=tuple(
                       (c[0], c[1], c[2]) for c in data["candidates"]),
                   reason=data.get("reason", ""))


@dataclasses.dataclass(frozen=True)
class Plan:
    """A concrete lowering of every declared channel: the full knob
    assignment one Engine loop runs under. Hashable; it enters the key of
    the engine's cached loops via :meth:`key` and is stamped on
    ``RunResult.plan``. ``use_kernel`` defaults to the kernel, the one
    legal value on the card."""

    mode: str = "fused"
    chunk_size: int = 64
    use_kernel: bool = True
    route_impl: str = "bucket"
    route_batch: str = "union"
    dense_threshold: float = 0.1
    source: str = "manual"    # "manual" | "auto" | "given"
    fingerprint: Optional[features.Fingerprint] = None
    decisions: Tuple[Decision, ...] = ()

    def key(self) -> Tuple:
        """The hashable knob tuple a loop is cached under."""
        return (self.mode, self.chunk_size, self.use_kernel,
                self.route_impl, self.route_batch, self.dense_threshold)

    def knobs(self) -> Dict[str, Any]:
        return {k: getattr(self, k) for k in KNOBS}

    def decision(self, knob: str) -> Optional[Decision]:
        for d in self.decisions:
            if d.knob == knob:
                return d
        return None

    def to_json(self) -> dict:
        return {
            **self.knobs(),
            "source": self.source,
            "fingerprint": (None if self.fingerprint is None
                            else self.fingerprint.to_json()),
            "decisions": [d.to_json() for d in self.decisions],
        }

    @classmethod
    def from_json(cls, data) -> "Plan":
        if isinstance(data, str):
            data = json.loads(data)
        return cls(
            mode=data["mode"], chunk_size=int(data["chunk_size"]),
            use_kernel=bool(data["use_kernel"]),
            route_impl=data["route_impl"], route_batch=data["route_batch"],
            dense_threshold=float(data["dense_threshold"]),
            source=data.get("source", "given"),
            fingerprint=(None if data.get("fingerprint") is None
                         else features.Fingerprint.from_json(
                             data["fingerprint"])),
            decisions=tuple(Decision.from_json(d)
                            for d in data.get("decisions", ())),
        )

    def explain(self) -> str:
        """The decision table ``python -m repro_torch plan --explain``
        prints: one row per knob with the chosen value, its source, and
        the predicted and measured cost of every candidate."""
        fmt = lambda v: "-" if v is None else f"{v * 1e3:9.3f}ms"
        lines = [f"plan [{self.source}]"
                 + (f"  fingerprint {self.fingerprint.cache_key()}"
                    if self.fingerprint else "")]
        header = (f"  {'knob':16s} {'chosen':10s} {'source':9s} "
                  f"{'candidate':10s} {'predicted':>11s} {'measured':>11s}")
        lines += [header, "  " + "-" * (len(header) - 2)]
        for knob in KNOBS:
            dec = self.decision(knob)
            chosen = getattr(self, knob)
            if dec is None or not dec.candidates:
                lines.append(f"  {knob:16s} {str(chosen):10s} "
                             f"{(dec.source if dec else 'manual'):9s}")
                if dec and dec.reason:
                    lines.append(f"    ^ {dec.reason}")
                continue
            chosen_name = str(chosen)
            if knob == "use_kernel":
                chosen_name = "kernel" if chosen else "reference"
            first = True
            for name, pred, meas in dec.candidates:
                head = (f"  {knob:16s} {str(chosen):10s} {dec.source:9s}"
                        if first else f"  {'':16s} {'':10s} {'':9s}")
                mark = "*" if name == chosen_name else " "
                lines.append(f"{head} {mark}{name:9s} {fmt(pred):>11s} "
                             f"{fmt(meas):>11s}")
                first = False
            if dec.reason:
                lines.append(f"    ^ {dec.reason}")
        return "\n".join(lines)


def manual_plan(*, mode: str = "fused", chunk_size: int = 64,
                route_batch: Optional[str] = None,
                dense_threshold: Optional[float] = None,
                explicit: Optional[Dict[str, Any]] = None) -> Plan:
    """The hand-set path as a Plan: every knob through its own config
    ladder (explicit > scope > env > default), with where each value came
    from — what ``Engine(plan="manual")`` stamps. ``use_kernel`` and
    ``route_impl`` are the port's one path (the kernels and the bucket
    ranks on the card, their plain versions on the CPU)."""
    from repro_torch.core import compose, routing

    explicit = explicit or {}
    values = {
        "mode": mode,
        "chunk_size": chunk_size,
        "use_kernel": True,
        "route_impl": "bucket",
        "route_batch": routing.resolve_batch(route_batch),
        "dense_threshold": compose.resolve_dense_threshold(dense_threshold),
    }
    decisions = tuple(
        Decision(knob=k, chosen=values[k],
                 source="explicit" if explicit.get(k) is not None
                 else "default",
                 reason="" if explicit.get(k) is not None
                 else "config ladder (scope > env > default)")
        for k in KNOBS)
    return Plan(source="manual", decisions=decisions, **values)


def _pick(costs, names):
    """The winner of one decision: by measured cost when every candidate
    was probed and the winner leads by :data:`PROBE_MARGIN`, else by the
    corpus fit; returns ``(winner, candidates, basis)``, winner None when
    neither source covers every candidate."""
    cands = tuple((n, costs[n]["predicted"], costs[n]["measured"])
                  for n in names)
    by_meas = {n: costs[n]["measured"] for n in names}
    by_pred = {n: costs[n]["predicted"] for n in names}
    basis = None
    if all(v is not None for v in by_meas.values()):
        best = min(by_meas, key=by_meas.get)
        rest = min(v for n, v in by_meas.items() if n != best)
        margin = rest / by_meas[best] if by_meas[best] > 0 else float("inf")
        if margin >= PROBE_MARGIN:
            return best, cands, f"measured probe, {margin:.2f}x margin"
        basis = (f"probe margin {margin:.2f}x < {PROBE_MARGIN}x, so the "
                 "corpus fit")
    if all(v is not None for v in by_pred.values()):
        return (min(by_pred, key=by_pred.get), cands,
                basis or "corpus fit")
    return None, cands, basis


class Planner:
    """Fingerprint -> Plan, memoized. One planner per Engine."""

    def __init__(self, calibrate: bool = True,
                 corpus: Optional[cm.Corpus] = None, explain: bool = False):
        self.calibrate = calibrate
        # time the probes on the card too, where they decide nothing but
        # fill explain's measured column
        self.explain = explain
        self._corpus = corpus
        self._memo: Dict[Tuple, Plan] = {}

    @property
    def corpus(self) -> cm.Corpus:
        if self._corpus is None:
            self._corpus = cm.Corpus.load()
        return self._corpus

    def plan(self, prog, pg, num_queries: int = 0,
             overrides: Optional[Dict[str, Any]] = None,
             fingerprint: Optional[features.Fingerprint] = None) -> Plan:
        """Lower ``prog``-on-``pg`` (Q query lanes) to a concrete Plan.

        overrides: explicitly-set knob values (None entries ignored),
        taken verbatim and recorded with source "explicit".
        fingerprint: the problem's fingerprint when the caller made it
        (a group's, reduced over its ranks); None: ``pg``'s own.
        """
        overrides = {k: v for k, v in (overrides or {}).items()
                     if v is not None}
        fp = (features.fingerprint(prog, pg, num_queries=num_queries)
              if fingerprint is None else fingerprint)
        memo_key = (fp, tuple(sorted(overrides.items())))
        hit = self._memo.get(memo_key)
        if hit is not None:
            return hit
        plan = self._decide(fp, overrides)
        self._memo[memo_key] = plan
        return plan

    def _decide(self, fp: features.Fingerprint,
                overrides: Dict[str, Any]) -> Plan:
        card = fp.backend == "cuda"
        model = cm.CostModel.build(
            fp, calibrate_probes=self.calibrate and (self.explain
                                                     or not card),
            corpus=self.corpus)
        values: Dict[str, Any] = {}
        decisions = []

        def decide(knob, chosen, candidates=(), reason=""):
            if knob in overrides:
                decisions.append(Decision(
                    knob=knob, chosen=overrides[knob], source="explicit",
                    candidates=tuple(candidates),
                    reason="caller-set knob — planner does not override"))
                values[knob] = overrides[knob]
            else:
                decisions.append(Decision(
                    knob=knob, chosen=chosen, source="planner",
                    candidates=tuple(candidates), reason=reason))
                values[knob] = chosen

        def on_card(legal, winner, basis):
            pick = ("no evidence covers every candidate" if winner is None
                    else f"the evidence picks {winner!r} ({basis})")
            return f"one legal value on the card ({legal}); {pick}"

        decide("mode", "fused", reason=(
            "the fused loop replays the supersteps as one CUDA graph, "
            "amortizing per-superstep dispatch"))
        decide("chunk_size", 64, reason=(
            "inert under mode='fused'; 64 balances dispatch amortization "
            "against halt-check latency for the chunked and serve "
            "substrates"))

        # use_kernel: the combine probe (plain on the CPU, where the port
        # has no kernel; the kernel on the card, its one legal value)
        winner, cands, basis = _pick(model.combine_costs(),
                                     ("reference", "kernel"))
        if card:
            decide("use_kernel", True, candidates=cands, reason=on_card(
                "ops refuses use_kernel=False on a CUDA tensor", winner,
                basis))
        elif winner is None:
            decide("use_kernel", True, candidates=cands,
                   reason="no cost evidence — the port's default")
        else:
            decide("use_kernel", winner == "kernel", candidates=cands,
                   reason=f"cheaper segment combine at e_cap ({basis})")

        # route_impl: the route probe (bucket ranks against the stable
        # argsort baseline; on the card the bucket kernel only)
        winner, cands, basis = _pick(model.route_costs(), ("bucket", "sort"))
        if card:
            decide("route_impl", "bucket", candidates=cands, reason=on_card(
                'routing refuses impl="sort" on a CUDA tensor', winner,
                basis))
        elif winner is None:
            decide("route_impl", "bucket", candidates=cands,
                   reason="no cost evidence — library default")
        else:
            decide("route_impl", winner, candidates=cands,
                   reason=f"cheaper routed exchange at m_cap ({basis})")

        # route_batch: live only for Q > 1 routed programs; the corpus
        # union-against-lane geomean is the prior
        prior = model.union_prior()
        if fp.num_queries > 1 and fp.channel_class == "routed":
            chosen = "union" if (prior or 1.0) >= 1.0 else "lane"
            decide("route_batch", chosen, candidates=(
                ("union", None, None), ("lane", None, None)),
                reason=(f"corpus union-vs-lane geomean "
                        f"{prior:.2f}x across routed programs"
                        if prior else "library default (no corpus)"))
        else:
            decide("route_batch", "union", reason=(
                "inert: no routed channels under a query batch "
                f"(Q={fp.num_queries}, class={fp.channel_class!r})"))

        thr, reason = model.dense_threshold()
        decide("dense_threshold", thr, reason=reason)

        return Plan(source="auto", fingerprint=fp,
                    decisions=tuple(decisions), **values)
