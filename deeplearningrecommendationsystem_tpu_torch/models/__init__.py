from deeplearningrecommendationsystem_tpu_torch.models.afm import AFM
from deeplearningrecommendationsystem_tpu_torch.models.base import ServingContext
from deeplearningrecommendationsystem_tpu_torch.models.din import DIN
from deeplearningrecommendationsystem_tpu_torch.models.lr import LogisticRegression
from deeplearningrecommendationsystem_tpu_torch.models.mf import MatrixFactorization

__all__ = ["AFM", "DIN", "LogisticRegression", "MatrixFactorization", "ServingContext"]
