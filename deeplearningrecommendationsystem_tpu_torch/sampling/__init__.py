from deeplearningrecommendationsystem_tpu_torch.sampling.negative import (
    NegativeSampler,
    negative_sample,
)

__all__ = ["NegativeSampler", "negative_sample"]
