"""The port's negative sampler: the properties ``tests/test_sampler.py``
checks for the JAX one. The two packages draw different random numbers, so
the port is held to the distribution: count, exclusion, user-major order,
fresh draws per call, and uniformity over each user's allowed items by a chi
square test at a fixed seed.
"""

import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from deeplearningrecommendationsystem_tpu_torch.sampling import NegativeSampler, negative_sample


def test_never_samples_excluded():
    rng = np.random.default_rng(0)
    excluded = rng.random((50, 200)) < 0.4
    users, items = negative_sample(torch.Generator().manual_seed(1), torch.from_numpy(excluded), 20)
    assert users.shape == items.shape == (50 * 20,)
    assert users.dtype == items.dtype == torch.int32
    assert not excluded[users.numpy(), items.numpy()].any()


def test_user_major_order():
    excluded = torch.zeros((5, 10), dtype=torch.bool)
    users, _ = negative_sample(torch.Generator().manual_seed(0), excluded, 3)
    assert users.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4]


def test_uniform_over_allowed():
    """Two users with different allowed sets; each user's draws are uniform
    over its own allowed items (chi square, p > 0.01 at this seed)."""
    excluded = np.zeros((2, 16), dtype=bool)
    excluded[0, ::2] = True  # user 0: odd items only
    excluded[1, :13] = True  # user 1: items 13, 14, 15
    n = 40_000
    users, items = negative_sample(torch.Generator().manual_seed(2), torch.from_numpy(excluded), n)
    users, items = users.numpy(), items.numpy()
    for u in (0, 1):
        mine = items[users == u]
        assert len(mine) == n and not excluded[u, mine].any()
        counts = np.bincount(mine, minlength=16)[~excluded[u]]
        assert chisquare(counts).pvalue > 0.01


def test_one_allowed_item_and_edges():
    excluded = np.ones((3, 7), dtype=bool)
    excluded[0, 0] = excluded[1, 6] = excluded[2, 3] = False
    _, items = negative_sample(torch.Generator().manual_seed(5), torch.from_numpy(excluded), 50)
    assert items.reshape(3, 50).tolist() == [[0] * 50, [6] * 50, [3] * 50]


def test_sampler_wrapper():
    rng = np.random.default_rng(4)
    seen = rng.random((30, 60)) < 0.2
    s = NegativeSampler(seen, seed=0, device="cpu")
    neg = s.sample(10)
    assert set(neg) == {"user", "item", "rating"}
    assert all(isinstance(v, np.ndarray) for v in neg.values())
    assert len(neg["user"]) == 30 * 10 and neg["item"].dtype == np.int32
    assert (neg["rating"] == 0).all() and neg["rating"].dtype == np.float32
    assert not seen[neg["user"], neg["item"]].any()
    neg2 = s.sample(10)  # the generator moves on
    assert not np.array_equal(neg["item"], neg2["item"])
    # the same seed gives the same draws
    again = NegativeSampler(seen, seed=0, device="cpu").sample(10)
    np.testing.assert_array_equal(again["item"], neg["item"])


def test_sampler_needs_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        NegativeSampler(np.zeros((2, 3), dtype=bool), seed=0)
