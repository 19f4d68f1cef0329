"""Tensor ops. The kernel modules (``serving_topk``, ``gather``, ``mf_epoch``,
``lr_epoch``, ``afm_attention``, ``din_head``, ``din_attention``) hold the
public wrappers and their plain versions; the CUDA launchers and their build
live in ``ops/cuda``."""
