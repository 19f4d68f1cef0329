"""A synthetic dataset in the ml-100k file format, made from a seed.

``write_ml100k_format`` writes ``u.data``, ``u.user`` and ``u.item`` in the
layout ``MovieLens100K`` reads, so the loader, the models and the server can be
driven at the real ml-100k shapes (943 users, 1682 items, 100,000 ratings)
where the real files are not on disk. It is a fixture, not a dataset: the
ratings are random, with a skewed item popularity and user activity.

What the loader relies on, and this writer guarantees:

* ``num_users`` and ``num_items`` are counted as the unique ids in ``u.data``,
  so every user and every item appears at least once, and ids run 1..N;
* every user has at least 20 ratings, as in ml-100k, and no (user, item) pair
  repeats;
* ``u.user`` holds both genders and all 21 ml-100k occupations (given at least
  21 users), and ``u.item`` holds 19 genre flags in columns 5-23.
"""

from __future__ import annotations

import os

import numpy as np

OCCUPATIONS = (
    "administrator", "artist", "doctor", "educator", "engineer",
    "entertainment", "executive", "healthcare", "homemaker", "lawyer",
    "librarian", "marketing", "none", "other", "programmer", "retired",
    "salesman", "scientist", "student", "technician", "writer",
)
NUM_GENRES = 19
MIN_RATINGS_PER_USER = 20


def _ratings_per_user(rng, num_users: int, num_items: int, num_ratings: int) -> np.ndarray:
    """Counts >= MIN_RATINGS_PER_USER and <= num_items that sum to num_ratings,
    with a heavy-tailed spread over users."""
    counts = np.full(num_users, MIN_RATINGS_PER_USER, dtype=np.int64)
    activity = rng.lognormal(0.0, 1.0, num_users)
    counts += rng.multinomial(num_ratings - counts.sum(), activity / activity.sum())
    counts = np.minimum(counts, num_items)
    while counts.sum() < num_ratings:  # hand the clipped excess to users with room
        room = np.nonzero(counts < num_items)[0]
        take = min(len(room), num_ratings - int(counts.sum()))
        counts[rng.choice(room, take, replace=False)] += 1
    return counts


def write_ml100k_format(
    path: str,
    seed: int,
    num_users: int = 943,
    num_items: int = 1682,
    num_ratings: int = 100_000,
) -> str:
    """Write ``u.data``, ``u.user`` and ``u.item`` under ``path``; returns ``path``."""
    if num_ratings < num_users * MIN_RATINGS_PER_USER or num_ratings > num_users * num_items:
        raise ValueError(
            f"num_ratings={num_ratings} must lie in "
            f"[{num_users * MIN_RATINGS_PER_USER}, {num_users * num_items}]"
        )
    if num_items > num_users * MIN_RATINGS_PER_USER or num_items < MIN_RATINGS_PER_USER:
        raise ValueError(f"num_items={num_items} cannot be covered by {num_users} users")
    rng = np.random.default_rng(seed)
    counts = _ratings_per_user(rng, num_users, num_items, num_ratings)

    # every item once: item i goes to a user with room for it, then each user
    # draws the rest of its items without replacement by a Zipf-like popularity
    popularity = 1.0 / np.arange(1, num_items + 1) ** 0.8
    popularity = popularity[rng.permutation(num_items)]
    forced = [[] for _ in range(num_users)]
    owners = np.repeat(np.arange(num_users), counts)  # one slot per rating
    for item, slot in enumerate(rng.choice(len(owners), num_items, replace=False)):
        forced[owners[slot]].append(item)
    users, items = [], []
    for u in range(num_users):
        mine = np.asarray(forced[u], dtype=np.int64)
        p = popularity.copy()
        p[mine] = 0.0
        rest = rng.choice(num_items, counts[u] - len(mine), replace=False, p=p / p.sum())
        chosen = np.concatenate([mine, rest])
        users.append(np.full(len(chosen), u))
        items.append(chosen)
    users, items = np.concatenate(users), np.concatenate(items)
    order = rng.permutation(len(users))  # ml-100k's u.data is not grouped by user
    users, items = users[order], items[order]
    stars = rng.integers(1, 6, len(users))
    stamps = 874_724_710 + np.sort(rng.integers(0, 20_000_000, len(users)))

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "u.data"), "w", encoding="ISO-8859-1") as f:
        f.writelines(
            f"{u + 1}\t{i + 1}\t{r}\t{t}\n" for u, i, r, t in zip(users, items, stars, stamps)
        )

    occupation = np.concatenate(
        [np.arange(len(OCCUPATIONS)), rng.integers(0, len(OCCUPATIONS), num_users)]
    )[:num_users]
    occupation = occupation[rng.permutation(num_users)]
    gender = np.where(np.arange(num_users) % 2 == 0, "M", "F")[rng.permutation(num_users)]
    ages = rng.integers(7, 74, num_users)
    with open(os.path.join(path, "u.user"), "w", encoding="ISO-8859-1") as f:
        f.writelines(
            f"{u + 1}|{ages[u]}|{gender[u]}|{OCCUPATIONS[occupation[u]]}|{10000 + u:05d}\n"
            for u in range(num_users)
        )

    genres = (rng.random((num_items, NUM_GENRES)) < 0.1).astype(np.int64)
    genres[np.arange(num_items), rng.integers(0, NUM_GENRES, num_items)] = 1
    with open(os.path.join(path, "u.item"), "w", encoding="ISO-8859-1") as f:
        for i in range(num_items):
            flags = "|".join(str(g) for g in genres[i])
            f.write(f"{i + 1}|Movie {i + 1} (1995)|01-Jan-1995|||{flags}\n")
    return path
