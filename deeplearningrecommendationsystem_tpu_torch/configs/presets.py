"""Per-model experiment presets.

The reference hardcodes every hyperparameter inside its per-model entry
scripts (SURVEY.md §2.4 table; e.g. scripts/neuralcf.py:60-66). Here each
script becomes one ``ExperimentConfig`` preset -- same negatives-per-user,
lr/weight-decay, epochs and eval K -- overridable from the CLI.

The port's own copy of the JAX package's ``configs/presets.py`` (a pure-Python
module), field for field, so the port imports nothing of the JAX package.
Fields of modes the port does not run yet (``mesh_shape``, the minibatch,
sparse and stream ``train_mode`` values) are kept so that a config means the
same thing in both packages; ``experiments.run_experiment`` rejects them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


@dataclasses.dataclass
class ExperimentConfig:
    model: str
    family: str  # 'feature' | 'pair' | 'seq' | 'matrix'
    negatives: Tuple[int, int, int] = (10, 10, 10)  # per user: train/valid/test
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    epochs: int = 100
    k: int = 50
    hist_len: int = 10  # seq family (training window, scripts/din.py:20)
    # seq family serving: True = the reference's full variable-length history
    # semantics (model/din.py:55-66) via the bucketed scorer; False = fixed
    # hist_len window (training distribution)
    full_history_serving: bool = True
    # DIEN extension: weight of the paper's auxiliary loss (bce + w * aux);
    # 0 = parity mode (the reference has no aux loss, model/dien.py:47,61)
    aux_weight: float = 0.0
    # training regime: 'fullbatch' = the reference's one-step-per-epoch
    # (parity mode); 'minibatch' = shuffled SGD (train/minibatch.py);
    # 'sparse' = minibatch with row-sparse embedding updates
    # (train/sparse_trainer.py; models implementing the sparse protocol);
    # 'stream' = host-streamed minibatches with device prefetch
    # (train/minibatch.py::fit_stream; dataset stays in host memory)
    train_mode: str = "fullbatch"
    batch_size: int = 8192  # minibatch/sparse modes
    sparse_optimizer: str = "lazy_adam"  # 'lazy_adam' | 'rowwise_adagrad'
    global_negatives: int = 150  # matrix family (sampled before splitting)
    item_major: bool = False  # matrix family: I-AutoRec orientation
    seed: int = 0
    track_metrics: bool = True
    # parallelism: (data, model) mesh axes; None = single device. model > 1
    # row-shards the id embedding tables (EP) via parallel/ep.py; data > 1
    # shards the batch (DP). E.g. (4, 2) on 8 devices.
    mesh_shape: Any = None
    ep_strategy: str = "psum"  # 'psum' | 'scatter'
    # False (with model axis > 1): leave the trained tables row-sharded --
    # the layout ShardedRecommender / parallel/serving.py serves from with
    # no unshard round-trip. run_experiment then SKIPS the dense catalog
    # ranking eval (it would need the replicated tables).
    unshard_params: bool = True
    # None = pure f32 (reference-parity numerics); 'bfloat16' = MXU fast path
    # with f32 master weights (see train.TrainConfig.compute_dtype)
    compute_dtype: Any = None
    # dense-path gather routes (train.TrainConfig fields of the same names;
    # CLI --fast-gathers sets both): one-hot-matmul backward / forward for
    # the id-table gathers -- the bench's measured-winner configuration
    matmul_gather_bwd: bool = False
    onehot_gather: bool = False
    model_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# negatives / lr / wd / epochs per reference script (SURVEY.md §2.4)
PRESETS: Dict[str, ExperimentConfig] = {
    "lr": ExperimentConfig(
        "lr", "feature", (10, 10, 10), 0.05, 0.0, 100
    ),
    "mf": ExperimentConfig(
        "mf", "pair", (180, 60, 60), 0.01, 1e-5, 100,
        model_kwargs={"embedding_dim": 64},
    ),
    "neuralcf": ExperimentConfig(
        "neuralcf", "pair", (60, 20, 20), 1e-3, 1e-5, 50,
        model_kwargs={"mf_dim": 256, "layers": (512, 256, 128, 64, 32)},
    ),
    "ffm": ExperimentConfig(
        "ffm", "feature", (10, 10, 10), 1e-3, 1e-5, 100,
        model_kwargs={"num_vector": 32},
    ),
    "widedeep": ExperimentConfig(
        "widedeep", "feature", (30, 10, 10), 1e-3, 1e-5, 100,
        model_kwargs={"hidden_units": (512, 256, 128, 1), "embedding_dim": 128},
    ),
    "deepfm": ExperimentConfig(
        "deepfm", "feature", (30, 10, 10), 1e-3, 1e-5, 200,
        model_kwargs={"hidden_units": (512, 256, 128, 1), "embedding_dim": 128},
    ),
    "nfm": ExperimentConfig(
        "nfm", "feature", (30, 10, 10), 1e-3, 1e-5, 200,
        model_kwargs={"hidden_units": (512, 256, 128, 1), "embedding_dim": 128},
    ),
    "afm": ExperimentConfig(
        "afm", "feature", (30, 10, 10), 1e-3, 1e-5, 300,
        model_kwargs={"embedding_dim": 128, "attention_dim": 64},
    ),
    "pnn": ExperimentConfig(
        "pnn", "feature", (30, 10, 10), 1e-3, 1e-5, 100,
        model_kwargs={"embedding_dim": 256, "hidden_units": (256, 128, 64, 32)},
    ),
    "deepcross": ExperimentConfig(
        "deepcross", "feature", (30, 10, 10), 1e-3, 1e-5, 200,
        model_kwargs={
            "cross_layers": 3,
            "deep_hidden_units": (512, 256, 128, 1),
            "embedding_dim": 128,
        },
    ),
    "deepcrossing": ExperimentConfig(
        "deepcrossing", "feature", (30, 10, 10), 1e-3, 1e-5, 100,
        model_kwargs={"embedding_dim": 32, "hidden_units": (256, 128, 64, 32)},
    ),
    "autorec": ExperimentConfig(
        "autorec", "matrix", learning_rate=5e-3, weight_decay=1e-5, epochs=100,
        global_negatives=150, model_kwargs={"hidden_units": 256},
    ),
    "i-autorec": ExperimentConfig(
        "i-autorec", "matrix", learning_rate=5e-3, weight_decay=1e-5, epochs=100,
        global_negatives=150, item_major=True, model_kwargs={"hidden_units": 256},
    ),
    "din": ExperimentConfig(
        "din", "seq", (30, 10, 10), 1e-3, 1e-5, 200,
        model_kwargs={"embed_size": 64},
    ),
    "dien": ExperimentConfig(
        "dien", "seq", (30, 10, 10), 1e-3, 1e-5, 200,
        model_kwargs={"embed_size": 16},
    ),
}
