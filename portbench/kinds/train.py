"""Full-batch training: the kind of traffic of a researcher's training run.

A unit of work is one whole ``Trainer.fit`` of the configuration's preset,
every epoch one Adam step on the whole train split (with the per-epoch
metrics where the mix's ``track_metrics``, or else the preset, keeps them),
from the seed's weights and a fresh optimizer state to the last epoch's
synchronise. Each unit restarts the same ``Trainer`` from the same weights,
through ``fit``'s own resume arguments, so every unit does the same work.

Set-up builds that one ``Trainer`` and drives it through the first
``checked_steps`` steps by the same call on the same batch (``fit`` of one
epoch, then of the rest from its parameters and optimizer state), which also
warms up every shape the window runs. Every unit of the window keeps its loss
history (on the device: the window waits for nothing more than the unit's
own synchronise) and the last unit its trained parameters.

Once the window has closed, the plain reference trains from the same weights
for as many epochs as a unit, on a batch the benchmark builds itself from the
fixture and the split (``feed``), and the program is held against it: each of
set-up's first steps (the loss, the first gradient as Adam got it, from its
first moment after one step, and the parameters' change over the steps);
every unit's first steps and whole loss history; the last unit's trained
parameters; and the program's batch against the benchmark's.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List

import torch
import torch.nn.functional as F

from deeplearningrecommendationsystem_tpu_torch.experiments import split_batches
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer

from portbench import refcommon
from portbench.program import Setup, replaced, synchronize

NUMBERS = ("loss_gap", "grad_gap", "median_change_gap", "history_gap", "final_change_gap",
           "feed_mismatch")


def _cpu(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu() for k, v in tree.items()}


def state_unchanged():
    """The optimizer's step returns the state it got."""
    return replaced(torch.optim.Adam, "step", lambda orig: lambda self, closure=None: None)


def half_batch():
    """The loss leaves out half of the batch and takes its mean over the rest."""
    def wrap(orig):
        def loss_fn(self, params, batch, labels, weights=None, denom=None):
            _, logits = orig(self, params, batch, labels, weights, denom)
            n = labels.shape[0] // 2
            return F.binary_cross_entropy_with_logits(logits[:n], labels[:n]), logits
        return loss_fn
    return replaced(Trainer, "loss_fn", wrap)


# the faults a training cell can have on one card, planted in the program
FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}


class Cell:
    def __init__(self, env):
        self.env = env
        self.setup = s = Setup(env.config, env.seed, env.device)
        cfg = s.cfg.replace(track_metrics=env.traffic.get("track_metrics", s.cfg.track_metrics))
        if cfg.train_mode != "fullbatch":
            raise ValueError(f"the train kind runs full-batch presets, not {cfg.train_mode!r}")
        with s.phase("batches"):
            self.batches = split_batches(cfg, s.data, env.device)
        self.config = TrainConfig(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                                  epochs=cfg.epochs, track_metrics=cfg.track_metrics,
                                  compute_dtype=cfg.compute_dtype)
        with s.phase("trainer"):
            self.trainer = Trainer(s.model, self.config, device=env.device)
            self.zero_state = {k: {"step": 0.0, "exp_avg": torch.zeros_like(w),
                                   "exp_avg_sq": torch.zeros_like(w)}
                               for k, w in s.weights.items()}
        self.rows = int(self.batches["train"][1].shape[0])
        with s.phase("costs"):
            self.costs = s.costs.train_unit(env.config, self.batches, cfg.epochs,
                                            cfg.track_metrics)
        with s.phase("checked_steps"):
            self.program = self._first_steps(int(env.traffic["checked_steps"]))
        self.histories: List[torch.Tensor] = []
        self.trained = None
        self._ref = None

    def _fit(self, epochs: int, params, opt_state):
        self.trainer.config = dataclasses.replace(self.config, epochs=epochs)
        try:
            b = self.batches
            return self.trainer.fit(b["train"], valid=b["valid"], test=b["test"],
                                    params=params, opt_state=opt_state)
        finally:
            self.trainer.config = self.config

    def _first_steps(self, steps: int) -> Dict:
        """The first ``steps`` steps from the seed's weights, through ``fit``."""
        first = self._fit(1, self.setup.weights, self.zero_state)
        b1 = refcommon.ADAM_BETAS[0]
        grads = {k: st["exp_avg"] / (1 - b1) for k, st in first.opt_state.items()}
        rest = self._fit(steps - 1, first.params, first.opt_state)
        losses = [float(x) for x in first.history["train_loss"]]
        losses += [float(x) for x in rest.history["train_loss"]]
        return {"losses": losses, "first_grad": _cpu(grads), "params": _cpu(rest.params)}

    def unit(self, spans) -> Dict[str, float]:
        b = self.batches
        res = self.trainer.fit(b["train"], valid=b["valid"], test=b["test"],
                               params=self.setup.weights, opt_state=self.zero_state)
        synchronize(self.env.device)
        self.histories.append(res.history["train_loss"])
        self.trained = res.params
        return {"rows": self.rows * self.config.epochs}

    def release(self) -> None:
        """Keep what the window produced on the host; free the program's
        state. The inputs and the weights stay."""
        self.program["histories"] = [h.detach().float().cpu() for h in self.histories]
        self.program["trained"] = None if self.trained is None else _cpu(self.trained)
        self.histories, self.trained = [], None
        self.trainer = None
        self.setup.model = None
        if self.env.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, precision: str) -> Dict:
        """The reference's training run in ``precision``: ``epochs`` steps on
        the benchmark's own batch, with the parameters after the checked
        steps kept; and how far the program's batch differs from that one."""
        s, env = self.setup, self.env
        batch, labels = self.batches["train"]
        ref_batch, ref_labels, mismatch = s.reference.train_batch(
            s.raw, s.data.train, batch, labels, env.config)
        with refcommon.precision(precision, env.device) as mm:
            out = refcommon.adam_steps(
                lambda p: s.reference.train_loss(mm, env.config, p, ref_batch, ref_labels),
                s.weights, self.config.learning_rate, self.config.weight_decay,
                self.config.epochs, keep_at=len(self.program["losses"]))
        return {"losses": out["losses"], "first_grad": _cpu(out["first_grad"]),
                "params_at": _cpu(out["params_at"]), "params": _cpu(out["params"]),
                "feed_mismatch": mismatch}

    def numbers(self, readings: Dict | None = None) -> Dict[str, float]:
        """The numbers compared: ``readings`` (the program's by default)
        against the reference's in float32. The worst relative gap of a loss
        over the checked steps, set-up's and every unit's first ones; the
        worst leaf's first gradient; the median leaf's change over the
        checked steps; the worst relative gap of a loss over every unit's
        whole history; the median leaf's change over the last unit's
        epochs; the program's rows that differ from the benchmark's batch.
        A change is taken at the median leaf, not the worst: the worst
        leaf's swings from seed to seed with a few small leaves (biases
        behind ReLUs and under the softmax) whose later steps turn on
        rounding. Leaves whose reference gradient is under a thousandth of
        the median leaf's are left out of a change: Adam moves them by
        round-off alone."""
        if self._ref is None:
            self._ref = self._reference("float32")
        got = self.program if readings is None else readings
        ref = self._ref
        k = len(got["losses"])
        w0 = _cpu(self.setup.weights)
        moved = refcommon.moved_leaves(ref["first_grad"])
        grads = refcommon.leaf_gaps(got["first_grad"], ref["first_grad"])
        changes = refcommon.leaf_gaps({n: got["params"][n] - w0[n] for n in got["params"]},
                                      {n: ref["params_at"][n] - w0[n] for n in moved}, moved)
        self.unit_gaps = [refcommon.loss_gap(h.tolist(), ref["losses"])
                          for h in got["histories"]]
        firsts = [refcommon.loss_gap(h[:k].tolist(), ref["losses"][:k])
                  for h in got["histories"]]
        trained = got["trained"]
        final = (float("inf") if trained is None else statistics.median(refcommon.leaf_gaps(
            {n: trained[n] - w0[n] for n in trained},
            {n: ref["params"][n] - w0[n] for n in moved}, moved).values()))
        self.leaves = {"grad_gap": grads, "change_gap": changes}
        return {"loss_gap": max([refcommon.loss_gap(got["losses"], ref["losses"][:k])] + firsts),
                "grad_gap": max(grads.values()),
                "median_change_gap": statistics.median(changes.values()),
                "history_gap": max(self.unit_gaps, default=float("inf")),
                "final_change_gap": final,
                "feed_mismatch": float(got.get("feed_mismatch", ref["feed_mismatch"]))}

    def control(self, precision: str = "tf32") -> Dict[str, float]:
        """The numbers of the reference in ``precision`` put in the
        program's place: its first steps, its history as the one unit, its
        trained parameters, its own batch."""
        low = self._reference(precision)
        k = len(self.program["losses"])
        readings = {"losses": low["losses"][:k], "first_grad": low["first_grad"],
                    "params": low["params_at"], "histories": [torch.tensor(low["losses"])],
                    "trained": low["params"], "feed_mismatch": 0}
        return self.numbers(readings)

    def attempted_failed(self, units: int, limits: Dict[str, float]):
        """Units run, and those whose loss history is out of its limit."""
        return units, sum(not (math.isfinite(g) and g <= limits["history_gap"])
                          for g in self.unit_gaps)
