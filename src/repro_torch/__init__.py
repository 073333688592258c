"""PyTorch/CUDA port of the channel-based Pregel engine (``repro``).

The package mirrors ``repro``'s layout module for module. The W logical
workers are an explicit leading tensor dimension instead of a ``vmap``
axis, so the axis-name collectives of the JAX package become tensor ops
(an ``all_to_all`` is a transpose of the ``(W_src, W_dst, ...)`` buffer,
a ``psum`` a reduction over dim 0). Entry points run on the CUDA device
unless the caller passes ``device="cpu"``; on the CPU every kernel
wrapper takes its plain PyTorch version.
"""
