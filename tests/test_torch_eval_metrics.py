"""The port's pointwise and ranking metrics against the JAX package's on the
same NumPy arrays.

Tolerance: rtol 1e-6 (float32 sums in another order); the thresholded
pointwise metrics are ratios of counts and come out equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.eval.pointwise import pointwise_metrics as jax_pointwise
from deeplearningrecommendationsystem_tpu.eval.pointwise import true_auc as jax_true_auc
from deeplearningrecommendationsystem_tpu.eval.ranking import ranking_metrics as jax_ranking
from deeplearningrecommendationsystem_tpu_torch.eval.pointwise import pointwise_metrics, true_auc
from deeplearningrecommendationsystem_tpu_torch.eval.ranking import ranking_metrics

RTOL = 1e-6


def _close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].dim() == 0, k
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_pointwise_metrics_match_jax(weighted, ties):
    rng = np.random.default_rng(int(weighted) * 2 + int(ties))
    n = 500
    y = (rng.random(n) < 0.3).astype(np.float32)
    p = rng.random(n).astype(np.float32)
    if ties:  # few distinct scores: the tie correction of the rank AUC matters
        p = np.round(p * 8) / 8
    w = (rng.random(n) < 0.6).astype(np.float32) if weighted else None
    want = jax_pointwise(jnp.asarray(y), jnp.asarray(p), None if w is None else jnp.asarray(w))
    got = pointwise_metrics(torch.from_numpy(y), torch.from_numpy(p),
                            None if w is None else torch.from_numpy(w))
    _close(got, want)
    np.testing.assert_allclose(
        float(true_auc(torch.from_numpy(y), torch.from_numpy(p))),
        float(jax_true_auc(jnp.asarray(y), jnp.asarray(p))), rtol=RTOL)


def test_pointwise_degenerate_splits():
    """No positives and no predicted positives: the safe divisions give 0."""
    y = np.zeros(10, np.float32)
    p = np.full(10, 0.1, np.float32)
    want = jax_pointwise(jnp.asarray(y), jnp.asarray(p))
    _close(pointwise_metrics(torch.from_numpy(y), torch.from_numpy(p)), want)


def _ranking_inputs(seed, U=40, I=90, La=12):
    rng = np.random.default_rng(seed)
    actual = np.full((U, La), -1, np.int32)
    for u in range(U):
        n = rng.integers(0 if u % 9 == 0 else 1, La + 1)  # some rows full, some empty
        actual[u, :n] = rng.choice(I, n, replace=False)
    scores = rng.standard_normal((U, I)).astype(np.float32)
    rec_full = np.argsort(-scores, axis=1, kind="stable").astype(np.int32)
    n_seen = rng.integers(0, 30, U).astype(np.int32)
    return actual, rec_full, n_seen


@pytest.mark.parametrize("reference_mode", [True, False])
@pytest.mark.parametrize("with_n_seen", [True, False])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_ranking_metrics_match_jax(reference_mode, with_n_seen, k):
    actual, rec_full, n_seen = _ranking_inputs(k)
    want = jax_ranking(jnp.asarray(actual), jnp.asarray(rec_full), k,
                       n_seen=jnp.asarray(n_seen) if with_n_seen else None,
                       reference_mode=reference_mode)
    got = ranking_metrics(torch.from_numpy(actual), torch.from_numpy(rec_full), k,
                          n_seen=torch.from_numpy(n_seen) if with_n_seen else None,
                          reference_mode=reference_mode)
    _close(got, want)
