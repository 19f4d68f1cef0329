"""DIN: target-aware attention pooling over the behaviour history.

The JAX package's ``models/din.py`` as an ``nn.Module`` (reference
model/din.py:9-66): a shared item embedding; an activation-unit MLP over
[hist, hist - target, target], softmax over the history axis, the weighted
sum as the user vector; concat with the target embedding into the final MLP.
Parameters, under the JAX names: ``item`` [I, D], ``att.{0,1,2}.{w,b}`` and
``fc.{0,1,2}.{w,b}``. Parity mode does not mask the left zero-padding (the
reference pads with item id 0, scripts/din.py:20-31); ``mask_padding=True``
masks the pad prefix.

Routes:

* unmasked (``mask_padding=False``, the preset), where
  ``ops/din_head.py::kernel_route`` takes the shapes (two hidden layers in
  each net, L at most 64, widths multiples of 4, fc widths at most 2048):
  the head is ``DinHead`` on every route -- the training forward and
  backward, and evaluation -- so the fused DIN head kernels run it.
  ``fused_head`` and ``pallas_serving`` are accepted for the JAX fields of
  those names, which picked the Pallas kernels over the XLA composition: all
  compute the same function, and here the shapes pick the route;
* the window catalog scorer (``ctx.history``) at those shapes: the DIN
  attention-pool kernel (``ops/din_attention.py``), then ``mlp`` over
  [pooled, target], as JAX's ``_apply(use_pallas=True)``;
* unmasked at any other shapes (another depth, a longer history, other
  widths): plain torch ``attention_pool`` then ``mlp``, the composition that
  the JAX DIN's default route takes (``fused_head=False``), on training,
  evaluation and the window scorer alike;
* masked (``mask_padding=True``, and ``apply_full`` / ``apply_full_embedded``,
  which full-history serving uses): plain torch ``attention_pool`` with the
  mask, then ``mlp``. This is a route in its own right, not a kernel's plain
  version: no kernel takes a mask, and the JAX package sends these through
  XLA as well.

The item lookups are ``gather_rows`` (the gather and ``onehot_grad`` kernel
pair); ``fused_gather`` and ``matmul_gather_bwd`` were TPU gather policies and
are accepted with no effect. ``indirect_hist`` takes the batch (hist_u [U, L],
user_idx [B], target [B]): each user's history is embedded once and the rows
of a [U, L * D] table gathered per example.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.models.base import (
    ServingContext,
    catalog_scores_from_history,
    catalog_scores_full_history,
    init_generator,
)
from deeplearningrecommendationsystem_tpu_torch.models.common import layer_list, nest, params_module
from deeplearningrecommendationsystem_tpu_torch.ops.attention import attention_pool
from deeplearningrecommendationsystem_tpu_torch.ops.din_attention import din_attention_pool
from deeplearningrecommendationsystem_tpu_torch.ops.din_head import din_head, kernel_route
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import embedding_init, mlp, mlp_init


class DIN(nn.Module):
    onehot_serving = True  # the JAX class attribute; a TPU gather policy, no effect here

    def __init__(
        self,
        num_items: int,
        embed_size: int = 64,
        attention_units: Sequence[int] = (128, 64, 1),
        fc_units: Sequence[int] = (256, 128, 1),
        mask_padding: bool = False,
        pallas_serving: bool = False,
        matmul_gather_bwd: bool = False,
        fused_head: bool = False,
        fused_gather: bool = False,
        indirect_hist: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.num_items = num_items
        self.embed_size = embed_size
        self.mask_padding = mask_padding
        self.pallas_serving = pallas_serving
        self.matmul_gather_bwd = matmul_gather_bwd
        self.fused_head = fused_head
        self.fused_gather = fused_gather
        self.indirect_hist = indirect_hist
        D = embed_size
        self.item = nn.Parameter(embedding_init(generator, num_items, D))
        self.att = params_module(mlp_init(generator, (3 * D,) + tuple(attention_units)))
        self.fc = params_module(mlp_init(generator, (2 * D,) + tuple(fc_units)))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def _embed(self, p: Mapping[str, Any], batch):
        """(hist ids [B, L], hist_e [B, L, D], target_e [B, D]) of a batch."""
        item = p["item"]
        if self.indirect_hist and len(batch) == 3:
            hist_u, uidx, target = batch
            U, L = hist_u.shape
            D = item.shape[1]
            uh = gather_rows(item, hist_u)  # [U, L, D]: once per user
            hist_e = gather_rows(uh.reshape(U, L * D), uidx).reshape(uidx.shape[0], L, D)
            return hist_u[uidx], hist_e, gather_rows(item, target)
        hist, target = batch
        return hist, gather_rows(item, hist), gather_rows(item, target)

    def _head(self, p, hist, hist_e, target_e, window: bool) -> torch.Tensor:
        att, fc = layer_list(p["att"]), layer_list(p["fc"])
        if self.mask_padding:
            # valid = positions after the leading zero-pad run; item 0 can
            # appear inside a history, so only the pad prefix is masked
            mask = torch.cummax((hist != 0).int(), dim=1).values > 0
            pooled = attention_pool(att, hist_e, target_e, mask)
        elif not kernel_route(att, fc, hist_e.shape[1], hist_e.shape[2]):
            pooled = attention_pool(att, hist_e, target_e)
        elif window:
            pooled = din_attention_pool(hist_e, target_e, att)
        else:
            return din_head(att, fc, hist_e, target_e)
        return mlp(fc, torch.cat([pooled, target_e], dim=-1))[:, 0]

    def apply_params(self, params: Mapping[str, Any], batch) -> torch.Tensor:
        """Logits [B] of a (hist [B, L], target [B]) batch, or of (hist_u [U, L],
        user_idx [B], target [B]) under ``indirect_hist``."""
        p = nest(params)
        return self._head(p, *self._embed(p, batch), window=False)

    def forward(self, batch) -> torch.Tensor:
        return self.apply_params(self.params(), batch)

    def _apply_window(self, params: Mapping[str, Any], batch) -> torch.Tensor:
        p = nest(params)
        return self._head(p, *self._embed(p, batch), window=True)

    def apply_full(self, params: Mapping[str, Any], batch) -> torch.Tensor:
        """Logits of right-padded histories with their valid lengths,
        (hist [B, L], target [B], length [B]): the masked softmax over the first
        ``length`` positions is the reference's softmax over the unpadded
        history (model/din.py:39-47)."""
        hist, target, length = batch
        return self.apply_full_embedded(params, (gather_rows(params["item"], hist), target, length))

    def apply_full_embedded(self, params: Mapping[str, Any], batch) -> torch.Tensor:
        """``apply_full`` from embedded histories (hist_e [B, L, D], target [B],
        length [B]): the full-history scorer embeds each user's history once."""
        hist_e, target, length = batch
        p = nest(params)
        target_e = gather_rows(p["item"], target)
        mask = torch.arange(hist_e.shape[1], device=hist_e.device)[None, :] < length[:, None]
        pooled = attention_pool(layer_list(p["att"]), hist_e, target_e, mask)
        return mlp(layer_list(p["fc"]), torch.cat([pooled, target_e], dim=-1))[:, 0]

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        params = self.params()
        if ctx.full_histories is not None:
            # the reference's serving: each user's complete history
            return catalog_scores_full_history(
                self.apply_full, params, ctx.full_histories, self.num_items, self.item.device,
                embed_fn=lambda p, h: gather_rows(p["item"], h),
                apply_embedded_fn=self.apply_full_embedded,
            )
        if ctx.history is None:
            raise ValueError("DIN serving needs ctx.history or ctx.full_histories")
        return catalog_scores_from_history(self._apply_window, params, ctx.history,
                                           self.num_items)
