"""PyTorch / CUDA port of ``deeplearningrecommendationsystem_tpu`` for NVIDIA Hopper.

The port mirrors the JAX package's module paths, so each module here has a
counterpart of the same name there. Plain tensor code is PyTorch; every Pallas
kernel on a ported path is a CUDA kernel written by hand for ``sm_90a``
(``csrc/``), launched through a checked wrapper that keeps a plain PyTorch
version of the same function beside it.

Device rule: entry points default to ``device="cuda"`` and raise when CUDA is
absent, unless the caller passes ``device="cpu"``. Nothing falls back to the
CPU on its own.

Ported so far, for the MF preset: serving (data loader, model, ``Recommender``,
``RecommenderServer`` and the two serving top-k kernels) and training (the
negative sampler, ``Trainer``, the pointwise and ranking metrics,
``experiments.run_experiment``, ``cli/serve.py``, the embedding gather and its
backward, and the fused MF trainer behind ``MatrixFactorization.fast_fit``).
"""

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec

__version__ = "0.1.0"

__all__ = ["FeatureSpec", "ML100K_SPEC", "resolve_device", "__version__"]
