"""The inputs of the plain references, built by the benchmark itself, and the
check that the program's own batch and serving inputs are the same.

The fixture's three files are parsed here, by ml-100k's own semantics, not
by the program's loader: ``u.data`` gives every rating's user and item
(0-based, file order); ``u.user`` a [U, 24] block, the min-max scaled age,
then gender and occupation one-hot over their sorted values; ``u.item`` the
[I, 19] genre flags. From these, the per-user split's arrays (the program's
draw from the seed, an input both sides take) and the users and items of
the program's examples, the benchmark builds what the program derived:
DeepFM's 45-column rows, DIN's history windows (each user's first
``hist_len`` training items in split order, left-padded with item 0) and
each user's complete history. Each builder returns the reference's copy and
the number of the program's rows or users that differ from it.

Plain NumPy and PyTorch only. Nothing here imports the program under test.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch


@dataclass
class Raw:
    users: np.ndarray  # int64 [R], every rating's user, 0-based, in file order
    items: np.ndarray  # int64 [R]
    num_users: int
    num_items: int
    user_features: np.ndarray  # float32 [U, 24]
    item_features: np.ndarray  # float32 [I, 19]

    def rated(self) -> np.ndarray:
        """Boolean [U, I]: True where the user rated the item."""
        out = np.zeros((self.num_users, self.num_items), dtype=bool)
        out[self.users, self.items] = True
        return out


def _fields(path: str) -> List[List[str]]:
    with open(path, encoding="ISO-8859-1") as f:
        return [line.rstrip("\n").split("|") for line in f if line.strip()]


def _one_hot(values: List[str]) -> np.ndarray:
    cats = sorted(set(values))
    out = np.zeros((len(values), len(cats)), dtype=np.float32)
    out[np.arange(len(values)), [cats.index(v) for v in values]] = 1.0
    return out


def parse(path: str) -> Raw:
    """The fixture at ``path`` (``u.data``, ``u.user``, ``u.item``)."""
    with open(os.path.join(path, "u.data"), encoding="ISO-8859-1") as f:
        ratings = np.array(f.read().split(), dtype=np.int64).reshape(-1, 4)
    users, items = ratings[:, 0] - 1, ratings[:, 1] - 1
    rows = sorted(_fields(os.path.join(path, "u.user")), key=lambda r: int(r[0]))
    age = np.array([float(r[1]) for r in rows])
    lo, hi = age.min(), age.max()
    age = (age - lo) / (hi - lo) if hi > lo else np.zeros_like(age)
    user_features = np.concatenate([age.astype(np.float32)[:, None],
                                    _one_hot([r[2] for r in rows]),
                                    _one_hot([r[3] for r in rows])], axis=1)
    irows = sorted(_fields(os.path.join(path, "u.item")), key=lambda r: int(r[0]))
    item_features = np.array([[float(v) for v in r[5:24]] for r in irows], dtype=np.float32)
    return Raw(users, items, int(len(np.unique(users))), int(len(np.unique(items))),
               user_features, item_features)


def histories(users: np.ndarray, items: np.ndarray, num_users: int) -> List[np.ndarray]:
    """Each user's items, in the order of the arrays."""
    order = np.argsort(users, kind="stable")
    bounds = np.searchsorted(users[order], np.arange(num_users + 1))
    return [items[order[bounds[u]:bounds[u + 1]]] for u in range(num_users)]


def windows(users: np.ndarray, items: np.ndarray, num_users: int, hist_len: int) -> np.ndarray:
    """[U, hist_len] int64: each user's first ``hist_len`` items in the order
    of the arrays, left-padded with item 0."""
    out = np.zeros((num_users, hist_len), dtype=np.int64)
    for u, h in enumerate(histories(np.asarray(users), np.asarray(items), num_users)):
        h = h[:hist_len]
        if len(h):
            out[u, hist_len - len(h):] = h
    return out


def feature_rows(raw: Raw, users: np.ndarray, items: np.ndarray) -> np.ndarray:
    """[N, 45] float32: ``[user, item, user features, item features]``."""
    return np.concatenate([users.astype(np.float32)[:, None], items.astype(np.float32)[:, None],
                           raw.user_features[users], raw.item_features[items]], axis=1)


def _multiset_gap(a: np.ndarray, b: np.ndarray) -> int:
    """How many elements the two multisets of integers do not share."""
    values = np.union1d(a, b)
    ca = np.bincount(np.searchsorted(values, a), minlength=len(values))
    cb = np.bincount(np.searchsorted(values, b), minlength=len(values))
    return int(np.abs(ca - cb).sum())


def _examples_gap(raw: Raw, train: Dict[str, np.ndarray], users: np.ndarray, items: np.ndarray,
                  labels: np.ndarray, ok: np.ndarray, same: np.ndarray | None = None) -> int:
    """Rows that are not sound examples, and positives missing or extra: a
    label is 1 or 0; the positives are the training split's pairs, each once;
    a negative is an item its user never rated. ``same`` [U] names, for each
    user, the first user that the program's rows cannot tell from it (DIN's:
    the first of those with its window); the positives are compared so."""
    pos, neg = labels == 1.0, labels == 0.0
    bad = ~ok | ~(pos | neg)
    rated = raw.rated()
    bad |= neg & ok & rated[np.where(ok, users, 0), np.where(ok, items, 0)]
    same = np.arange(raw.num_users) if same is None else same
    code = np.int64(raw.num_items)
    got = same[users[pos & ok]].astype(np.int64) * code + items[pos & ok]
    want = same[train["user"]].astype(np.int64) * code + train["item"]
    return int(bad.sum()) + _multiset_gap(got, want)


def _ids(x: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Integer ids in [0, n) from ``x``, and where they are such."""
    ok = (x == np.round(x)) & (x >= 0) & (x < n)
    return np.where(ok, x, 0).astype(np.int64), ok


def feature_batch(raw: Raw, train: Dict[str, np.ndarray], batch: torch.Tensor,
                  labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """DeepFM's training rows, built from the users and items of the
    program's rows ``batch`` [N, 45]: (rows, labels, mismatch), the rows on
    ``batch``'s device; mismatch counts the program's rows that differ from
    them and the examples that are not sound (``_examples_gap``)."""
    x = batch.detach().cpu().numpy()
    y = labels.detach().float().cpu().numpy()
    users, ok_u = _ids(x[:, 0], raw.num_users)
    items, ok_i = _ids(x[:, 1], raw.num_items)
    rows = feature_rows(raw, users, items)
    differ = (rows != x).any(axis=1)
    mismatch = int((differ & ok_u & ok_i).sum())
    mismatch += _examples_gap(raw, train, users, items, y, ok_u & ok_i)
    dev = batch.device
    return torch.from_numpy(rows).to(dev), torch.from_numpy(y).to(dev), mismatch


def history_batch(raw: Raw, train: Dict[str, np.ndarray], batch, labels: torch.Tensor,
                  hist_len: int) -> Tuple[Tuple[torch.Tensor, torch.Tensor], torch.Tensor, int]:
    """DIN's training batch ``(windows [N, hist_len], targets [N])``, built
    from the training split: each of the program's rows is given the user
    whose window its history is and for whom its target and label make a
    sound example (a training item for a positive, an item never rated for a
    negative), and that user's window. Returns (batch, labels, mismatch);
    mismatch counts the rows no user fits and the positives missing or extra.
    """
    hist = batch[0].detach().cpu().numpy().astype(np.int64)
    target = batch[1].detach().cpu().numpy().astype(np.int64)
    y = labels.detach().float().cpu().numpy()
    win = windows(train["user"], train["item"], raw.num_users, hist_len)
    trained = np.zeros((raw.num_users, raw.num_items), dtype=bool)
    trained[train["user"], train["item"]] = True
    rated = raw.rated()
    by_window: Dict[bytes, List[int]] = {}
    for u in range(raw.num_users):
        by_window.setdefault(win[u].tobytes(), []).append(u)
    keys, inverse = np.unique(hist, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    owner = np.full(len(target), -1, dtype=np.int64)
    t_ok = (target >= 0) & (target < raw.num_items)
    t = np.where(t_ok, target, 0)
    for k, key in enumerate(keys):
        rows = np.nonzero(inverse == k)[0]
        for u in by_window.get(key.astype(np.int64).tobytes(), []):
            fits = (((y[rows] == 1.0) & trained[u, t[rows]])
                    | ((y[rows] == 0.0) & ~rated[u, t[rows]])) & t_ok[rows] & (owner[rows] < 0)
            owner[rows[fits]] = u
    ok = owner >= 0
    same = np.array([by_window[win[u].tobytes()][0] for u in range(raw.num_users)])
    mismatch = _examples_gap(raw, train, np.where(ok, owner, 0), t, y, ok, same)
    dev = batch[0].device
    ref = (torch.from_numpy(win[np.where(ok, owner, 0)]).to(dev), torch.from_numpy(t).to(dev))
    return ref, torch.from_numpy(y).to(dev), mismatch


def histories_mismatch(raw: Raw, full_histories) -> int:
    """The users whose complete history, as the program serves it, is not
    the items of their ratings in file order."""
    want = histories(raw.users, raw.items, raw.num_users)
    if full_histories is None or len(full_histories) != len(want):
        return raw.num_users
    return sum(not np.array_equal(np.asarray(got, dtype=np.int64), w)
               for got, w in zip(full_histories, want))


def features_mismatch(raw: Raw, user_features: torch.Tensor, item_features: torch.Tensor) -> int:
    """The user and item rows of the program's feature blocks that differ
    from the fixture's."""
    n = 0
    for got, want in ((user_features, raw.user_features), (item_features, raw.item_features)):
        got = None if got is None else got.detach().float().cpu().numpy()
        if got is None or got.shape != want.shape:
            n += want.shape[0]
        else:
            n += int((got != want).any(axis=1).sum())
    return n
