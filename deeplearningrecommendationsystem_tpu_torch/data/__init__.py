from deeplearningrecommendationsystem_tpu_torch.data.movielens import MovieLens100K
from deeplearningrecommendationsystem_tpu_torch.data.synthetic import write_ml100k_format

__all__ = ["MovieLens100K", "write_ml100k_format"]
