from deeplearningrecommendationsystem_tpu_torch.models.base import ServingContext
from deeplearningrecommendationsystem_tpu_torch.models.mf import MatrixFactorization

__all__ = ["MatrixFactorization", "ServingContext"]
