"""The port's ml-100k loader against the JAX package's, on one synthetic dataset."""

import numpy as np
import pytest

from deeplearningrecommendationsystem_tpu.data import MovieLens100K as JaxMovieLens
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.data.synthetic import OCCUPATIONS

U, I, R = 60, 150, 3000


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    return write_ml100k_format(str(tmp_path_factory.mktemp("ml")), seed=3,
                               num_users=U, num_items=I, num_ratings=R)


@pytest.fixture(scope="module")
def both(dataset_dir):
    return (JaxMovieLens(dataset_dir, seed=0, use_native=False),
            MovieLens100K(dataset_dir, seed=0))


def test_synthetic_dataset_shape(dataset_dir):
    raw = np.loadtxt(f"{dataset_dir}/u.data", dtype=np.int64)
    assert raw.shape == (R, 4)
    users, items = raw[:, 0] - 1, raw[:, 1] - 1
    assert set(users) == set(range(U)) and set(items) == set(range(I))
    assert np.bincount(users).min() >= 20
    assert len(set(zip(users, items))) == R  # no repeated (user, item)
    with open(f"{dataset_dir}/u.user") as f:
        rows = [line.rstrip("\n").split("|") for line in f]
    assert {r[2] for r in rows} == {"F", "M"}
    assert {r[3] for r in rows} == set(OCCUPATIONS) and len(OCCUPATIONS) == 21
    with open(f"{dataset_dir}/u.item") as f:
        assert all(len(line.rstrip("\n").split("|")) == 24 for line in f)


def test_counts_and_spec_match(both):
    jx, pt = both
    assert (pt.num_users, pt.num_items) == (jx.num_users, jx.num_items) == (U, I)
    assert pt.gender_categories == jx.gender_categories
    assert pt.occupation_categories == jx.occupation_categories
    assert pt.spec.width == jx.spec.width == 45
    assert pt.spec == type(pt.spec)(**jx.spec.__dict__)


@pytest.mark.parametrize("split", ["data", "train", "valid", "test"])
def test_splits_bit_identical(both, split):
    jx, pt = both
    for key in ("user", "item", "rating"):
        a, b = getattr(jx, split)[key], getattr(pt, split)[key]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["user_features", "item_features"])
def test_feature_blocks_match(both, name):
    jx, pt = both
    a, b = getattr(jx, name), getattr(pt, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_seen_mask_and_derived_matrices_match(both):
    jx, pt = both
    np.testing.assert_array_equal(pt.seen_mask(pt.train, pt.valid, pt.test),
                                  jx.seen_mask(jx.train, jx.valid, jx.test))
    np.testing.assert_array_equal(pt.seen_mask(pt.train), jx.seen_mask(jx.train))
    np.testing.assert_array_equal(pt.feature_matrix(pt.test), jx.feature_matrix(jx.test))
    users = np.array([0, 5, 17], dtype=np.int32)
    np.testing.assert_array_equal(pt.cross_features(users), jx.cross_features(users))
    np.testing.assert_array_equal(pt.itemid_matrix(pt.valid), jx.itemid_matrix(jx.valid))
    np.testing.assert_array_equal(pt.history_matrix(pt.train, 10), jx.history_matrix(jx.train, 10))
    np.testing.assert_array_equal(pt.rating_matrix(pt.test, item_major=True),
                                  jx.rating_matrix(jx.test, item_major=True))
    for key in ("user", "item"):
        np.testing.assert_array_equal(pt.concat_splits(pt.train, pt.test)[key],
                                      jx.concat_splits(jx.train, jx.test)[key])
