"""LM training, the port of ``repro.train``: the optimizer, the train step,
the synthetic data pipeline and checkpoints."""
