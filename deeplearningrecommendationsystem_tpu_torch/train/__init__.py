from deeplearningrecommendationsystem_tpu_torch.train.optim import torch_adam
from deeplearningrecommendationsystem_tpu_torch.train.sparse import (
    LazyAdamState,
    RowwiseAdagradState,
    sparse_table_update,
)
from deeplearningrecommendationsystem_tpu_torch.train.minibatch import (
    fit_minibatch,
    fit_stream,
)
from deeplearningrecommendationsystem_tpu_torch.train.sparse_trainer import (
    fit_minibatch_sparse,
    fit_stream_sparse,
    merge_tables,
    pop_tables,
)
from deeplearningrecommendationsystem_tpu_torch.train.trainer import TrainConfig, Trainer, TrainResult

__all__ = [
    "torch_adam",
    "TrainConfig",
    "Trainer",
    "TrainResult",
    "LazyAdamState",
    "RowwiseAdagradState",
    "sparse_table_update",
    "fit_minibatch",
    "fit_stream",
    "fit_minibatch_sparse",
    "fit_stream_sparse",
    "merge_tables",
    "pop_tables",
]
