"""Logistic Regression over the 45-column feature vector.

The JAX package's ``models/lr.py`` as an ``nn.Module``: id-bias tables plus a
linear layer over the 43 dense columns (reference model/lr.py:11-37). Its
parameters are those of ``models/common.py::linear_part_init``, under the JAX
names: ``user_bias`` [U, 1], ``item_bias`` [I, 1], ``wide.w`` [43, 1] and
``wide.b`` [1].

* ``apply_params(params, x)`` is the JAX ``apply``: logits [B] of a [B, 45]
  batch, or, with ``wide_input``, of a ``widen(x)`` batch [B, U + I + 43].
* ``fast_fit`` trains through the fused LR kernels (``ops/lr_epoch.py``),
  ``mode="compact"`` (default) or ``"wide"``.
* ``score_catalog`` scores the catalog through the model itself;
  ``serving_factors`` gives the rank-2 factors whose product is the same
  scores, for the fused top-k kernel.

``matmul_gather_bwd`` is accepted for the JAX field of that name: on the TPU
it swapped the bias lookups' scatter for a one-hot matmul; here every route
is the same gather kernel pair (``ops/embedding.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models.base import (
    ServingContext,
    catalog_scores_from_features,
    init_generator,
)
from deeplearningrecommendationsystem_tpu_torch.models.common import (
    FeatureModel,
    linear_part,
    linear_part_init,
    nest,
    params_module,
)
from deeplearningrecommendationsystem_tpu_torch.ops.linear import linear
from deeplearningrecommendationsystem_tpu_torch.ops.lr_epoch import (
    lr_fullbatch_train,
    lr_fullbatch_train_compact,
)


class LogisticRegression(FeatureModel):
    def __init__(
        self,
        spec: FeatureSpec = ML100K_SPEC,
        matmul_gather_bwd: bool = False,
        wide_input: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.spec = spec
        self.matmul_gather_bwd = matmul_gather_bwd
        self.wide_input = wide_input
        part = params_module(linear_part_init(generator, spec))
        self.user_bias, self.item_bias, self.wide = part.user_bias, part.item_bias, part.wide

    def widen(self, x: torch.Tensor) -> torch.Tensor:
        """[B, 45] -> [B, U + I + 43]: the id one-hots and the dense block,
        built on the device with one scatter."""
        U, I = self.spec.num_users, self.spec.num_items
        u, i = self.spec.ids(x)
        dense = self.spec.dense(x)
        out = torch.zeros((x.shape[0], U + I + dense.shape[1]), dtype=x.dtype, device=x.device)
        out[:, U + I:] = dense
        cols = torch.stack([u, U + i], dim=1)
        return out.scatter_(1, cols, 1.0)

    def apply_params(self, params: Mapping[str, Any], x: torch.Tensor) -> torch.Tensor:
        p = nest(params)
        if self.wide_input:
            U, I = self.spec.num_users, self.spec.num_items
            x = x.to(p["wide"]["w"].dtype)  # one-hots and dense columns in the weights' dtype
            return (x[:, :U] @ p["user_bias"] + x[:, U:U + I] @ p["item_bias"]
                    + linear(p["wide"], x[:, U + I:]))[:, 0]
        return linear_part(p, x, self.spec)[:, 0]

    @torch.no_grad()
    def fused_inputs(self, params: Mapping[str, Any], x: torch.Tensor, y: torch.Tensor,
                     mode: str = "compact") -> tuple:
        """The arrays ``fast_fit`` hands the fused trainer of ``mode``:
        (uid, iid, dense_aug [B, 44], y, w0 [1, U + I + 44]) for "compact",
        (x_aug [B, U + I + 44], y, w0 [U + I + 44, 1]) for "wide"; w0 holds
        the user biases, the item biases, the wide weights and its bias."""
        p = nest(params)
        w0 = torch.cat([p["user_bias"][:, 0], p["item_bias"][:, 0], p["wide"]["w"][:, 0],
                        p["wide"]["b"]]).detach().float()
        y = y.float().contiguous()
        ones = torch.ones((x.shape[0], 1), dtype=torch.float32, device=x.device)
        if mode == "compact":
            u, i = self.spec.ids(x)
            dense_aug = torch.cat([self.spec.dense(x).float(), ones], 1).contiguous()
            return u.contiguous(), i.contiguous(), dense_aug, y, w0[None].contiguous()
        if mode == "wide":
            return torch.cat([self.widen(x.float()), ones], 1), y, w0[:, None].contiguous()
        raise ValueError(f"mode {mode!r}: 'compact' or 'wide'")

    @torch.no_grad()
    def fast_fit(self, params: Mapping[str, Any], x: torch.Tensor, y: torch.Tensor, epochs: int,
                 learning_rate: float, mode: str = "compact"
                 ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Full-batch Adam training through the fused LR kernels: the same
        loss, Adam (no weight decay) and pre-update loss history as
        ``Trainer.fit``. Returns (params by name, losses [epochs]) and leaves
        the module's own parameters as they are.

        ``mode="compact"``: one segment-padded weight row, unpadded here
        (u_pad = U, i_pad = I, d_pad = 44), from the ids and the dense block.
        ``mode="wide"``: over the design matrix [widen(x), 1] [B, U + I + 44].
        """
        U, I = self.spec.num_users, self.spec.num_items
        D = self.spec.dense_width
        args = self.fused_inputs(params, x, y, mode)
        if mode == "compact":
            w, losses = lr_fullbatch_train_compact(*args, epochs, learning_rate, u_pad=U, i_pad=I)
        else:
            w, losses = lr_fullbatch_train(*args, epochs, learning_rate)
        w = w.reshape(-1)
        out = {"user_bias": w[:U, None], "item_bias": w[U:U + I, None],
               "wide.w": w[U + I:U + I + D, None], "wide.b": w[U + I + D:]}
        return {k: v.clone() for k, v in out.items()}, losses

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        if self.wide_input:
            return catalog_scores_from_features(
                lambda p, b: self.apply_params(p, self.widen(b)), self.params(), ctx)
        return catalog_scores_from_features(self.apply_params, self.params(), ctx)

    def serving_factors(self, ctx: ServingContext):
        """LR's pair score is rank-1 separable, score(u, i) = u_part[u] +
        i_part[i] (the bias tables and the wide layer split into its
        user-feature and genre column blocks), so serving is
        ``[u_part, 1] @ [1, i_part]^T``: the fused top-k kernel at D = 2, with
        no [U, I] scores."""
        w, b = self.wide.w[:, 0], self.wide.b[0]
        n_user_cols = ctx.user_features.shape[1]  # age + gender + occupation
        u_part = self.user_bias[:, 0] + ctx.user_features @ w[:n_user_cols] + b
        i_part = self.item_bias[:, 0] + ctx.item_features @ w[n_user_cols:]
        return (torch.stack([u_part, torch.ones_like(u_part)], 1),
                torch.stack([torch.ones_like(i_part), i_part], 1))
