"""DIEN: attention-scaled history -> interest-evolution GRU -> MLP head.

The JAX package's ``models/dien.py`` as an ``nn.Module`` (reference
model/dien.py:8-81): DIN's activation unit gives each history item a softmax
weight against the target (``ops/attention.py::din_attention_weights``); the
history embeddings, scaled by those weights and never pooled, run through a
GRU (``ops/gru.py``), whose final state is the interest vector; concat with
the target embedding into the fc MLP. ``use_augru=True`` is the JAX
package's extension, the DIEN paper's two layers: an extractor GRU over the
raw embeddings (``gru``), then an AUGRU over its states (``gru_ev``), the
attention scaling its update gate.

Parameters, under the JAX names: ``item`` [I, D], ``att.{i}.{w,b}``,
``gru.{w_ih,w_hh,b_ih,b_hh}``, ``fc.{i}.{w,b}`` and, with ``use_augru``,
``gru_ev.*``. The item lookups are ``gather_rows`` (the gather and
``onehot_grad`` kernel pair); the attention, the GRU and the MLP are plain
torch, as they are XLA in the JAX package, so DIEN launches no DIN head or
pool kernel. ``matmul_gather_bwd`` was a TPU gather policy and is accepted
with no effect.

``indirect_hist`` takes the batch (hist_u [U, L], user_idx [B], target [B]),
recognised by its 1-D third element: each user's history is embedded once
and the rows of a [U, L * D] table gathered per example. An auxiliary-loss
batch carries its per-step negatives [B, L] last: (hist, target, neg_hist),
or (hist_u, user_idx, target, neg_hist).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deeplearningrecommendationsystem_tpu_torch.models.base import (
    ServingContext,
    catalog_scores_from_history,
    catalog_scores_full_history,
    init_generator,
)
from deeplearningrecommendationsystem_tpu_torch.models.common import layer_list, nest, params_module
from deeplearningrecommendationsystem_tpu_torch.ops.attention import din_attention_weights
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.gru import augru, gru, gru_init
from deeplearningrecommendationsystem_tpu_torch.ops.linear import embedding_init, mlp, mlp_init


class DIEN(nn.Module):
    def __init__(
        self,
        num_items: int,
        embed_size: int = 16,
        attention_units: Sequence[int] = (64, 32, 1),
        fc_units: Sequence[int] = (128, 64, 1),
        use_augru: bool = False,
        matmul_gather_bwd: bool = False,
        indirect_hist: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        generator = init_generator(generator, device)
        self.num_items = num_items
        self.embed_size = embed_size
        self.use_augru = use_augru
        self.matmul_gather_bwd = matmul_gather_bwd
        self.indirect_hist = indirect_hist
        D = embed_size
        self.item = nn.Parameter(embedding_init(generator, num_items, D))
        self.att = params_module(mlp_init(generator, (3 * D,) + tuple(attention_units)))
        self.gru = params_module(gru_init(generator, D, D))
        self.fc = params_module(mlp_init(generator, (2 * D,) + tuple(fc_units)))
        if use_augru:
            self.gru_ev = params_module(gru_init(generator, D, D))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def _interest(self, p: Mapping[str, Any], hist_e, w, return_states: bool = False):
        """The interest vector [B, H] from the history embeddings and the
        attention weights; with ``return_states`` also the extractor's states
        [B, L, H] (None in parity mode), which the auxiliary loss shares.

        Parity mode: one GRU over the attention-scaled embeddings, the
        reference's DIEN (model/dien.py:47,61). ``use_augru``: the extractor
        GRU over the raw embeddings, then the AUGRU over its states."""
        if self.use_augru:
            states = gru(p["gru"], hist_e, return_sequence=True)
            interest = augru(p["gru_ev"], states, w)
            return (interest, states) if return_states else interest
        interest = gru(p["gru"], hist_e * w[..., None])
        return (interest, None) if return_states else interest

    def _embed_batch(self, p: Mapping[str, Any], batch):
        """(hist_e [B, L, D], target_e [B, D], rest): ``rest`` holds the
        batch's trailing elements (an auxiliary-loss batch's ``neg_hist``)."""
        item = p["item"]
        if self.indirect_hist and len(batch) >= 3 and batch[2].dim() == 1:
            hist_u, uidx, target = batch[0], batch[1], batch[2]
            U, L = hist_u.shape
            D = item.shape[1]
            uh = gather_rows(item, hist_u)  # [U, L, D]: once per user
            hist_e = gather_rows(uh.reshape(U, L * D), uidx).reshape(uidx.shape[0], L, D)
            return hist_e, gather_rows(item, target), batch[3:]
        hist, target = batch[0], batch[1]
        return gather_rows(item, hist), gather_rows(item, target), batch[2:]

    def _logits(self, p, interest, target_e) -> torch.Tensor:
        return mlp(layer_list(p["fc"]), torch.cat([interest, target_e], dim=-1))[:, 0]

    def apply_params(self, params: Mapping[str, Any], batch) -> torch.Tensor:
        """Logits [B] of a (hist [B, L], target [B]) batch (a trailing
        ``neg_hist`` is ignored), or of the ``indirect_hist`` batch."""
        p = nest(params)
        hist_e, target_e, _ = self._embed_batch(p, batch)
        w = din_attention_weights(layer_list(p["att"]), hist_e, target_e)  # [B, L]
        return self._logits(p, self._interest(p, hist_e, w), target_e)

    def forward(self, batch) -> torch.Tensor:
        return self.apply_params(self.params(), batch)

    def apply_full(self, params: Mapping[str, Any], batch) -> torch.Tensor:
        """Logits of right-padded histories with their valid lengths, (hist
        [B, L], target [B], length [B]): the attention's softmax masked to the
        first ``length`` positions and the GRU's state read at step ``length -
        1``, which is the reference's final state over the unpadded history
        (model/dien.py:57-68)."""
        hist, target, length = batch
        return self.apply_full_embedded(params, (gather_rows(params["item"], hist), target, length))

    def apply_full_embedded(self, params: Mapping[str, Any], batch) -> torch.Tensor:
        """``apply_full`` from embedded histories (hist_e [B, L, D], target [B],
        length [B]): the full-history scorer embeds each user's history once."""
        hist_e, target, length = batch
        p = nest(params)
        target_e = gather_rows(p["item"], target)
        L = hist_e.shape[1]
        mask = torch.arange(L, device=hist_e.device)[None, :] < length[:, None]
        w = din_attention_weights(layer_list(p["att"]), hist_e, target_e, mask)
        if self.use_augru:
            # past ``length`` the masked attention is 0, so the AUGRU's update
            # gate is 0 there and the state is held
            ex_states = gru(p["gru"], hist_e, return_sequence=True)
            states = augru(p["gru_ev"], ex_states, w, return_sequence=True)
        else:
            states = gru(p["gru"], hist_e * w[..., None], return_sequence=True)  # [B, L, H]
        idx = torch.clamp(length - 1, 0, L - 1)
        interest = torch.take_along_dim(states, idx[:, None, None].long(), dim=1)[:, 0]
        return self._logits(p, interest, target_e)

    def score_catalog(self, ctx: ServingContext) -> torch.Tensor:
        params = self.params()
        if ctx.full_histories is not None:
            return catalog_scores_full_history(
                self.apply_full, params, ctx.full_histories, self.num_items, self.item.device,
                embed_fn=lambda p, h: gather_rows(p["item"], h),
                apply_embedded_fn=self.apply_full_embedded,
            )
        if ctx.history is None:
            raise ValueError("DIEN serving needs ctx.history or ctx.full_histories")
        return catalog_scores_from_history(self.apply_params, params, ctx.history,
                                           self.num_items, tile=8)

    @staticmethod
    def _aux_from_states(states, hist_e, neg_e) -> torch.Tensor:
        """The DIEN paper's next-behaviour loss from the extractor's states:
        -mean[log sigmoid(<h_t, e_{t+1}>) + log sigmoid(-<h_t, n_{t+1}>)]."""
        h_t = states[:, :-1, :]  # predicts step t + 1
        pos = torch.sum(h_t * hist_e[:, 1:, :], dim=-1)
        neg = torch.sum(h_t * neg_e[:, 1:, :], dim=-1)
        return -torch.mean(F.logsigmoid(pos) + F.logsigmoid(-neg))

    def apply_with_aux(self, params: Mapping[str, Any], batch):
        """(logits [B], the auxiliary loss) of a batch that ends in its
        per-step negatives ``neg_hist`` [B, L], in one forward. With
        ``use_augru`` the auxiliary loss reads the extractor's states; in
        parity mode the main GRU takes the scaled embeddings, so one more GRU
        runs over the raw ones."""
        p = nest(params)
        hist_e, target_e, rest = self._embed_batch(p, batch)
        neg_hist = rest[0]
        w = din_attention_weights(layer_list(p["att"]), hist_e, target_e)
        interest, states = self._interest(p, hist_e, w, return_states=True)
        if states is None:
            states = gru(p["gru"], hist_e, return_sequence=True)
        neg_e = gather_rows(p["item"], neg_hist)  # [B, L, D]
        return self._logits(p, interest, target_e), self._aux_from_states(states, hist_e, neg_e)

    def auxiliary_loss(self, params: Mapping[str, Any], hist: torch.Tensor,
                       neg_hist: torch.Tensor) -> torch.Tensor:
        """The auxiliary loss alone, from the extractor GRU over ``hist``'s
        embeddings (``apply_with_aux`` is the form the Trainer takes)."""
        p = nest(params)
        hist_e = gather_rows(p["item"], hist)
        neg_e = gather_rows(p["item"], neg_hist)
        states = gru(p["gru"], hist_e, return_sequence=True)
        return self._aux_from_states(states, hist_e, neg_e)
