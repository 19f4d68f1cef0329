from deeplearningrecommendationsystem_tpu_torch.cf.neighborhood import (
    cf_eval,
    item_cf_recommend,
    item_cf_scores,
    load_base_test,
    user_cf_recommend,
    user_cf_scores,
)
from deeplearningrecommendationsystem_tpu_torch.cf.gdcf import gdcf_train

__all__ = [
    "cf_eval",
    "item_cf_recommend",
    "item_cf_scores",
    "load_base_test",
    "user_cf_recommend",
    "user_cf_scores",
    "gdcf_train",
]
