"""CUDA kernels written for Hopper: the build (``build.py``) and one checked
launcher module per source in ``csrc/``."""
