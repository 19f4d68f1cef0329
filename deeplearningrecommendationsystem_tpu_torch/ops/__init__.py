"""Tensor ops. ``serving_topk`` holds the public top-k wrappers; the CUDA
launchers and their build live in ``ops/cuda``."""
