"""The program's side of a run: the configuration as the program takes it,
its model, and the inputs both sides share.

The program under test is ``deeplearningrecommendationsystem_tpu_torch``;
this is the one module of the benchmark, with the kinds of traffic, that
calls into it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS, ExperimentConfig
from deeplearningrecommendationsystem_tpu_torch.experiments import build_model

from portbench import data as fixture
from portbench import spec, weights

# the configuration file's keys that are ExperimentConfig fields
FIELDS = ("negatives", "learning_rate", "weight_decay", "epochs", "hist_len",
          "full_history_serving", "track_metrics", "model_kwargs", "compute_dtype")


def experiment_config(config: Dict, seed: int) -> ExperimentConfig:
    """The preset the configuration names, with the configuration's fields
    and the run's seed."""
    base = PRESETS[config["preset"]]
    if base.model != config["model"]:
        raise ValueError(f"preset {config['preset']!r} runs {base.model!r}, "
                         f"the configuration {config['model']!r}")
    fields = {k: config[k] for k in FIELDS if k in config}
    if "negatives" in fields:
        fields["negatives"] = tuple(fields["negatives"])
    return base.replace(seed=seed, **fields)


class Setup:
    """What every kind of traffic starts from: the data, the program's
    configuration and model, and the weights drawn from the seed (loaded
    into the model), with the configuration's reference. ``phases`` holds
    the seconds of each step of the set-up, the kinds' own steps too."""

    def __init__(self, config: Dict, seed: int, device: torch.device):
        self.config, self.seed, self.device = config, seed, device
        self.phases: Dict[str, float] = {}
        self.cfg = experiment_config(config, seed)
        with self.phase("fixture"):
            self.data, self.raw = fixture.load(config, seed)
        self.reference = spec.reference(config["model"])
        self.costs = spec.costs(config["model"])
        with self.phase("weights"):
            specs = self.reference.param_specs(config, self.raw.num_users, self.raw.num_items)
            self.weights = weights.draw(specs, seed, device)
            self.model = build_model(self.cfg, self.data).to(device)
            weights.load_into(self.model, self.weights)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.device)
            self.phases[name] = time.perf_counter() - t0

    def reference_inputs(self) -> Dict:
        """What the reference serves from, as the benchmark parsed the
        fixture: every rating's user and item, and the user and item feature
        blocks."""
        r = self.raw
        return {"users": r.users, "items": r.items,
                "num_users": r.num_users, "num_items": r.num_items,
                "user_features": torch.from_numpy(r.user_features).to(self.device),
                "item_features": torch.from_numpy(r.item_features).to(self.device)}


def synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def replaced(owner, name: str, fn):
    """Plants a fault: ``owner.name`` is ``fn(original)`` for the block and
    the original after it; nothing is written to the program's files. Each
    kind of traffic lists the faults its cells can have as ``FAULTS``."""
    orig = getattr(owner, name)
    setattr(owner, name, fn(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)
