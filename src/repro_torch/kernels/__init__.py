"""Hand-written CUDA kernels (``csrc/``), their launch wrappers, their
plain PyTorch versions (``ref``) and the dispatch between them (``ops``)."""
