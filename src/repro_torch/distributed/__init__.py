"""Resilience helpers of the port (``repro_torch.distributed``)."""
