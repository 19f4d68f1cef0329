"""AFM: attention-weighted pairwise interactions plus the linear part.

The JAX package's ``models/afm.py`` as an ``nn.Module`` (reference
model/afm.py:6-83), with its two quirks: age enters as the raw scalar
broadcast to the embedding width, not through a table (model/afm.py:54), and
the attention parameters are standard normal like the reference's
``torch.randn`` (model/afm.py:22-24). Parameters, under the JAX names:
``tables.{user,item,gender,occupation,genre}`` [V, D], ``att_w`` [D, A],
``att_b`` [A], ``att_h`` [A, 1], ``att_out.{w,b}`` and ``wide.*`` (the linear
part of ``models/common.py``).

The pool over the 15 pair products is ``AfmAttentionPool`` on every route:
under autograd when training (the forward and backward kernels), the forward
kernel alone when serving. ``fused_attention`` and ``pallas_serving`` are
accepted for the JAX fields of those names, which picked the Pallas kernels
over the XLA pair (``pairwise_products`` + ``afm_attention``): all three
compute the same function, and here the kernels are the one route.
``onehot_serving`` was a TPU gather policy for catalog scoring and has no
effect here.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models.base import init_generator
from deeplearningrecommendationsystem_tpu_torch.models.common import (
    FeatureModel,
    linear_part,
    linear_part_init,
    nest,
    params_module,
)
from deeplearningrecommendationsystem_tpu_torch.ops.afm_attention import AfmAttentionPool
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import embed_fields, init_field_tables
from deeplearningrecommendationsystem_tpu_torch.ops.linear import linear, linear_init


class AFM(FeatureModel):
    onehot_serving = True  # the JAX class attribute; a TPU gather policy, no effect here

    def __init__(
        self,
        spec: FeatureSpec = ML100K_SPEC,
        embedding_dim: int = 128,
        attention_dim: int = 64,
        pallas_serving: bool = False,
        fused_attention: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.spec = spec
        self.embedding_dim = embedding_dim
        self.attention_dim = attention_dim
        self.pallas_serving = pallas_serving
        self.fused_attention = fused_attention
        D, A = embedding_dim, attention_dim

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=generator.device)

        self.tables = params_module(init_field_tables(generator, spec, D))
        self.att_w = nn.Parameter(normal(D, A))
        self.att_b = nn.Parameter(normal(A))
        self.att_h = nn.Parameter(normal(A, 1))
        self.att_out = params_module(linear_init(generator, D, 1))
        self.wide = params_module(linear_part_init(generator, spec))

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        """Logits [B] of a [B, 45] batch."""
        p = nest(params)
        e = embed_fields(p["tables"], x, self.spec)
        age = x[:, self.spec.age_col:self.spec.age_col + 1]
        fields = torch.stack(
            [e["user"], e["item"], age.expand(x.shape[0], self.embedding_dim), e["gender"],
             e["occupation"], e["genre"]], dim=1)
        pooled = AfmAttentionPool.apply(fields, p["att_w"], p["att_b"], p["att_h"])
        return (linear_part(p["wide"], x, self.spec) + linear(p["att_out"], pooled))[:, 0]
