"""Problem fingerprints (the port of ``repro.plan``, as far as the
engine's overflow escalation needs it): :mod:`repro_torch.plan.features`
keys the capacity scales an escalation learned. The cost model and the
planner (``Engine(plan="auto")``) are not ported yet (see ROADMAP)."""
from repro_torch.plan.features import Fingerprint, fingerprint

__all__ = ["Fingerprint", "fingerprint"]
