from deeplearningrecommendationsystem_tpu_torch.configs.presets import PRESETS, ExperimentConfig

__all__ = ["PRESETS", "ExperimentConfig"]
