"""PyTorch / CUDA port of ``deeplearningrecommendationsystem_tpu`` for NVIDIA Hopper.

The port mirrors the JAX package's module paths, so each module here has a
counterpart of the same name there. Plain tensor code is PyTorch; every Pallas
kernel on a ported path is a CUDA kernel written by hand for ``sm_90a``
(``csrc/``), launched through a checked wrapper that keeps a plain PyTorch
version of the same function beside it.

Device rule: entry points default to ``device="cuda"`` and raise when CUDA is
absent, unless the caller passes ``device="cpu"``. Nothing falls back to the
CPU on its own.

Ported, for all 15 presets: serving (data loader, models, ``Recommender``,
``RecommenderServer``, the two serving top-k kernels) and full-batch training
(the negative sampler, ``Trainer`` with its auxiliary-loss hook, the pointwise
and ranking metrics, ``experiments.run_experiment``, ``cli/run.py``,
``cli/serve.py``, the embedding gather and its backward, the fused MF and LR
trainers, AFM's attention pool, DIN's fused head and attention pool, and
DIEN's GRU in plain torch); the minibatch, stream and sparse training modes
(``train/minibatch.py``, ``data/stream.py``, ``train/sparse.py``,
``train/sparse_trainer.py``), checkpoints (``runtime/checkpoint.py``) and
classic CF (``cf/``, ``cli/cf.py``); the parallel layer, one process a rank
over ``torch.distributed`` (``parallel/``, ``runtime/distributed.py``: DP,
row-sharded tables, sharded serving, ``--mesh`` on both CLIs), the scaling
model (``runtime/scaling_model.py``) and the native parser
(``data/native.py``).
"""

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec

__version__ = "0.1.0"

__all__ = ["FeatureSpec", "ML100K_SPEC", "resolve_device", "__version__"]
