from deeplearningrecommendationsystem_tpu_torch.models.afm import AFM
from deeplearningrecommendationsystem_tpu_torch.models.autorec import AutoRec
from deeplearningrecommendationsystem_tpu_torch.models.base import ServingContext
from deeplearningrecommendationsystem_tpu_torch.models.dcn import DCN
from deeplearningrecommendationsystem_tpu_torch.models.deepcrossing import DeepCrossing
from deeplearningrecommendationsystem_tpu_torch.models.deepfm import DeepFM
from deeplearningrecommendationsystem_tpu_torch.models.dien import DIEN
from deeplearningrecommendationsystem_tpu_torch.models.din import DIN
from deeplearningrecommendationsystem_tpu_torch.models.ffm import FFM
from deeplearningrecommendationsystem_tpu_torch.models.lr import LogisticRegression
from deeplearningrecommendationsystem_tpu_torch.models.mf import MatrixFactorization
from deeplearningrecommendationsystem_tpu_torch.models.neuralcf import NeuralCF
from deeplearningrecommendationsystem_tpu_torch.models.nfm import NFM
from deeplearningrecommendationsystem_tpu_torch.models.pnn import PNN
from deeplearningrecommendationsystem_tpu_torch.models.widedeep import WideDeep

__all__ = ["AFM", "AutoRec", "DCN", "DIEN", "DIN", "DeepCrossing", "DeepFM", "FFM",
           "LogisticRegression", "MatrixFactorization", "NFM", "NeuralCF", "PNN", "ServingContext",
           "WideDeep"]
