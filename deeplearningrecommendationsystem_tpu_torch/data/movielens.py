"""MovieLens-100k implicit-feedback data pipeline (host side, NumPy).

The same semantics as the JAX package's ``data/movielens.py`` on its NumPy
path, and the same arrays bit for bit:

* ``u.data``  -> (user, item) pairs, every rating set to 1 (implicit feedback)
* ``u.user``  -> [num_users, 24] block: [min-max age, one-hot gender(2),
  one-hot occupation(21)] (one-hot category order = sorted unique values)
* ``u.item``  -> [num_items, 19] multi-hot genre block
* per-user shuffled 60/20/20 split (train_end = int(n*.6),
  valid_end = train_end + int(n*.2)) drawn from ``np.random.default_rng(seed)``
* 45-column feature matrices ``[user_id, item_id, age, gender, occupation,
  genres]``, per-user item/history matrices and dense seen-item masks.

This module emits NumPy; models and the ``Recommender`` own device placement.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec

Split = Dict[str, np.ndarray]  # {'user': int32 [N], 'item': int32 [N], 'rating': float32 [N]}


def _minmax(x: np.ndarray) -> np.ndarray:
    lo, hi = x.min(), x.max()
    return (x - lo) / (hi - lo) if hi > lo else np.zeros_like(x, dtype=np.float64)


class MovieLens100K:
    """Loads ml-100k and exposes splits, feature blocks and masks as arrays."""

    def __init__(self, dataset_path: str, seed: Optional[int] = 0):
        self.path = dataset_path
        rng = np.random.default_rng(seed)
        self._load_numpy(dataset_path)

        self.spec = FeatureSpec(
            num_users=self.num_users,
            num_items=self.num_items,
            num_genders=len(self.gender_categories),
            num_occupations=len(self.occupation_categories),
            num_genres=self.item_features.shape[1],
        )

        # ---- implicit feedback + per-user 60/20/20 split ----
        ratings = np.ones(len(self._users), dtype=np.float32)
        self.data: Split = {"user": self._users, "item": self._items, "rating": ratings}
        self.train, self.valid, self.test = self._split_per_user(rng)

    # ------------------------------------------------------------------
    def _load_numpy(self, dataset_path: str) -> None:
        # ---- interactions (u.data: user \t item \t rating \t ts) ----
        raw = np.loadtxt(os.path.join(dataset_path, "u.data"), dtype=np.int64)
        users = raw[:, 0].astype(np.int32) - 1  # 0-base ids
        items = raw[:, 1].astype(np.int32) - 1
        self._users, self._items = users, items
        self.num_users = int(len(np.unique(users)))
        self.num_items = int(len(np.unique(items)))

        # ---- user features (u.user: id|age|gender|occupation|zip) ----
        with open(os.path.join(dataset_path, "u.user"), encoding="ISO-8859-1") as f:
            rows = [line.rstrip("\n").split("|") for line in f if line.strip()]
        uid = np.array([int(r[0]) for r in rows]) - 1
        age = np.array([float(r[1]) for r in rows])
        gender = [r[2] for r in rows]
        occupation = [r[3] for r in rows]
        order = np.argsort(uid)
        age, gender, occupation = (
            age[order],
            [gender[i] for i in order],
            [occupation[i] for i in order],
        )
        self.gender_categories = sorted(set(gender))
        self.occupation_categories = sorted(set(occupation))
        n_users = len(uid)
        gender_oh = np.zeros((n_users, len(self.gender_categories)), dtype=np.float32)
        for i, g in enumerate(gender):
            gender_oh[i, self.gender_categories.index(g)] = 1.0
        occ_oh = np.zeros((n_users, len(self.occupation_categories)), dtype=np.float32)
        for i, o in enumerate(occupation):
            occ_oh[i, self.occupation_categories.index(o)] = 1.0
        age_norm = _minmax(age).astype(np.float32)[:, None]
        # [U, 24] = [age, gender(2), occupation(21)]
        self.user_features = np.concatenate([age_norm, gender_oh, occ_oh], axis=1)

        # ---- item features (u.item: id|title|...|19 genre flags) ----
        with open(os.path.join(dataset_path, "u.item"), encoding="ISO-8859-1") as f:
            irows = [line.rstrip("\n").split("|") for line in f if line.strip()]
        iid = np.array([int(r[0]) for r in irows]) - 1
        genres = np.array([[float(v) for v in r[5:24]] for r in irows], dtype=np.float32)
        self.item_features = genres[np.argsort(iid)]  # [I, 19]

    # ------------------------------------------------------------------
    def _split_per_user(self, rng: np.random.Generator):
        users, items = self.data["user"], self.data["item"]
        tr_u, tr_i, va_u, va_i, te_u, te_i = [], [], [], [], [], []
        for u in range(self.num_users):
            idx = np.nonzero(users == u)[0]
            idx = rng.permutation(idx)
            n = len(idx)
            train_end = int(n * 0.6)
            valid_end = train_end + int(n * 0.2)
            tr_u.append(np.full(train_end, u, dtype=np.int32))
            tr_i.append(items[idx[:train_end]])
            va_u.append(np.full(valid_end - train_end, u, dtype=np.int32))
            va_i.append(items[idx[train_end:valid_end]])
            te_u.append(np.full(n - valid_end, u, dtype=np.int32))
            te_i.append(items[idx[valid_end:]])

        def pack(us, its) -> Split:
            u = np.concatenate(us)
            i = np.concatenate(its)
            return {"user": u, "item": i, "rating": np.ones(len(u), dtype=np.float32)}

        return pack(tr_u, tr_i), pack(va_u, va_i), pack(te_u, te_i)

    # ------------------------------------------------------------------
    def _feature_rows(self, u: np.ndarray, i: np.ndarray) -> np.ndarray:
        return np.concatenate(
            [
                u.astype(np.float32)[:, None],
                i.astype(np.float32)[:, None],
                self.user_features[u],
                self.item_features[i],
            ],
            axis=1,
        )

    def feature_matrix(self, split: Split) -> np.ndarray:
        """[N, 45] feature matrix for a (user,item,rating) split."""
        return self._feature_rows(split["user"], split["item"])

    def cross_features(self, users: Optional[np.ndarray] = None) -> np.ndarray:
        """[len(users) * num_items, 45] feature rows for every (user, item) pair."""
        if users is None:
            users = np.arange(self.num_users, dtype=np.int32)
        I = self.num_items
        u = np.repeat(users.astype(np.int32), I)
        i = np.tile(np.arange(I, dtype=np.int32), len(users))
        return self._feature_rows(u, i)

    def seen_mask(self, *splits: Split) -> np.ndarray:
        """Boolean [U, I]: True where (u, i) appears in any given split."""
        mask = np.zeros((self.num_users, self.num_items), dtype=bool)
        for s in splits:
            mask[s["user"], s["item"]] = True
        return mask

    def _per_user(self, split: Split) -> list:
        per_user = [[] for _ in range(self.num_users)]
        for u, i in zip(split["user"], split["item"]):
            per_user[int(u)].append(int(i))
        return per_user

    def itemid_matrix(self, split: Split) -> np.ndarray:
        """Per-user interacted item ids in split row order, right-padded with -1 ([U, max_len])."""
        per_user = self._per_user(split)
        max_len = max((len(l) for l in per_user), default=1)
        out = np.full((self.num_users, max(max_len, 1)), -1, dtype=np.int32)
        for u, lst in enumerate(per_user):
            out[u, : len(lst)] = lst
        return out

    def history_matrix(self, split: Split, hist_len: int) -> np.ndarray:
        """Per-user behavior history [U, hist_len] int32: keep-first truncation,
        LEFT-pad with item id 0 (a real item, unmasked, as in the reference)."""
        out = np.zeros((self.num_users, hist_len), dtype=np.int32)
        for u, lst in enumerate(self._per_user(split)):
            if len(lst) >= hist_len:
                out[u] = lst[:hist_len]
            elif lst:
                out[u, hist_len - len(lst) :] = lst
        return out

    def rating_matrix(
        self, negatives: Optional[Split] = None, fill_value: float = 0.5, item_major: bool = False
    ) -> np.ndarray:
        """Dense rating matrix for AutoRec: 1=positive, 0=sampled negative,
        ``fill_value`` elsewhere; ``item_major=True`` yields the [I, U] transpose."""
        m = np.full((self.num_users, self.num_items), fill_value, dtype=np.float32)
        if negatives is not None:
            m[negatives["user"], negatives["item"]] = 0.0
        m[self.data["user"], self.data["item"]] = 1.0
        return m.T if item_major else m

    @staticmethod
    def concat_splits(*splits: Split) -> Split:
        return {
            k: np.concatenate([s[k] for s in splits]) for k in ("user", "item", "rating")
        }
