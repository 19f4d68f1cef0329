from deeplearningrecommendationsystem_tpu_torch.train.optim import torch_adam
from deeplearningrecommendationsystem_tpu_torch.train.trainer import TrainConfig, Trainer, TrainResult

__all__ = ["TrainConfig", "Trainer", "TrainResult", "torch_adam"]
