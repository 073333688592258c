"""Cost-model-driven channel planning (``Engine(plan="auto")``), the
port of ``repro.plan``.

- :mod:`repro_torch.plan.features` — graph/program fingerprints.
- :mod:`repro_torch.plan.cost_model` — corpus-fitted cost curves and
  disk-cached calibration probes on the local device.
- :mod:`repro_torch.plan.planner` — :class:`Plan` / :class:`Decision` /
  :class:`Planner`: abstract channel declarations lowered to the
  concrete knob assignment one loop runs under.
"""
from repro_torch.plan.cost_model import Corpus, CostModel
from repro_torch.plan.features import Fingerprint, fingerprint
from repro_torch.plan.planner import Decision, Plan, Planner, manual_plan

__all__ = ["Corpus", "CostModel", "Fingerprint", "fingerprint",
           "Decision", "Plan", "Planner", "manual_plan"]
