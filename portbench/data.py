"""The data of a run: the ml-100k-shaped fixture, written and loaded by the
program's own writer and loader.

The fixture's ratings come from the configuration's fixed ``fixture.seed``,
so every run holds the same data set at ml-100k's shapes, as a deployment
trains on one data set; the run's ``--seed`` draws the per-user split, the
negatives and the weights. It is written under ``TMPDIR``, loaded by the
program and parsed by the benchmark itself for the references
(``feed.parse``), and removed.
"""

from __future__ import annotations

import tempfile
from typing import Dict, Tuple

from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format

from portbench import feed


def load(config: Dict, seed: int) -> Tuple[MovieLens100K, feed.Raw]:
    """The program's data set, and the benchmark's own parse of its files."""
    fx = config["fixture"]
    with tempfile.TemporaryDirectory(prefix="portbench-") as path:
        write_ml100k_format(path, seed=fx["seed"], num_users=fx["num_users"],
                            num_items=fx["num_items"], num_ratings=fx["num_ratings"])
        return MovieLens100K(path, seed=seed), feed.parse(path)
