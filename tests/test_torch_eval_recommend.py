"""The port's ``eval/recommend.py`` against the JAX package's, on the same
NumPy scores and seen mask.

Scores are half-integers in a narrow range, so many tie: rankings must agree
exactly, tie order included (every sort on both sides keeps index order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.eval import recommend as jax_rec
from deeplearningrecommendationsystem_tpu_torch.eval import recommend as pt_rec

U, I = 23, 97


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(7)
    scores = (rng.integers(-4, 4, (U, I)) + 0.5).astype(np.float32)  # no zero, many ties
    seen = rng.random((U, I)) < 0.3
    return scores, seen


@pytest.mark.parametrize("name", ["mask_seen", "full_ranking"])
def test_masked_functions_match_jax(inputs, name):
    scores, seen = inputs
    got = getattr(pt_rec, name)(torch.from_numpy(scores), torch.from_numpy(seen))
    want = getattr(jax_rec, name)(jnp.asarray(scores), jnp.asarray(seen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 10, I])
def test_top_k_unseen_matches_jax(inputs, k):
    scores, seen = inputs
    got = pt_rec.top_k_unseen(torch.from_numpy(scores), torch.from_numpy(seen), k)
    want = jax_rec.top_k_unseen(jnp.asarray(scores), jnp.asarray(seen), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_score_ranking_and_seen_to_tail_match_jax(inputs):
    scores, seen = inputs
    got_rank = pt_rec.score_ranking(torch.from_numpy(scores))
    want_rank = jax_rec.score_ranking(jnp.asarray(scores))
    np.testing.assert_array_equal(got_rank.numpy(), np.asarray(want_rank))
    got = pt_rec.seen_to_tail(got_rank, torch.from_numpy(seen))
    want = jax_rec.seen_to_tail(want_rank, jnp.asarray(seen))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the partition is the masked full ranking over the unseen items
    full = pt_rec.full_ranking(torch.from_numpy(scores), torch.from_numpy(seen))
    n_unseen = (~seen).sum(axis=1)
    for u in range(U):
        assert got[u, : n_unseen[u]].tolist() == full[u, : n_unseen[u]].tolist()
