"""Row-sparse minibatch training: the kind of traffic of one GPU of a DLRM job.

A unit of work is one ``fit_minibatch_sparse`` epoch (``optimizer=
"rowwise_adagrad"``) over the mix's ``steps`` batches of the configuration's
``batch_size`` rows, from the seed's weights: the tables train row-wise,
the dense part on the sparse trainer's Adam. Each unit first restores, in
place, the rows its batches touch and the dense leaves from the copies made
at set-up (timed inside the unit); the row states start from zero in every
``fit_minibatch_sparse`` call. The epoch's order comes from the run's seed
(``train/minibatch.py::epoch_order``), so every unit runs the same batches.

The data, drawn on the device at set-up from the seed at the published
shapes (no Criteo files are in the repository): each bag's first id
Zipf(``zipf_a``) over the table's held rows, the ranks placed by a seeded
permutation, its other ids that id plus uniform offsets modulo the held
rows; the dense features log(1 + x) of counts x = floor(exp(N(mean, std)));
labels Bernoulli(``positive_rate``).

Set-up (its own, with ``phases``: no ml-100k fixture): the model built on the
card (its tables drawn there) and the benchmark's weights filled in; the
batches; the rows the batches touch, and their copies; from the
seed's weights, one step on the unit's first batch (its loss and dense
gradient are checked) and the unit's first ``checked_steps`` steps (their
losses, touched rows and dense leaves are checked); one whole unit as
warm-up. In the units of a traced run that the profiler does not watch,
the program's recorder is on: each unit reports its steps' device time of
the bags (``train.lookup`` and ``dlrm.bags``), the cross (``dlrm.cross``) and
the row update (``train.sparse_update``), and the counters ``train.ids`` and
``train.rows_touched``.

Once the window has closed, the program's tables are freed and the plain
reference (``reference/dlrm.py``) draws the same weights and trains a unit's
first ``checked_steps`` steps on the same batches. Compared: set-up's step
losses and every window unit's first ``checked_steps``, every step of every
unit finite (``loss_gap``); the first step's dense gradient (``grad_gap``);
the touched rows (``rows_gap``) and dense leaves (``dense_change_gap``) after
set-up's checked steps, each by its change from the initial weights; and the
program's per-table ids against the reference's own slicing
(``feed_mismatch``). Steps after the checked ones are not compared: the
first Adam step makes the loss jump (to 6.5-11.7 at step 2), and from then on
two float32 runs that differ in rounding alone part about fivefold a step, so
that by step 16 their losses differ by up to 66% and TF32's by 11-50%
(a dozen seeds on one H100; PERF.md §2).

On the CPU (the benchmark's own tests) the mix's ``cpu`` block sets a
rehearsal size: its ``batch_size`` and ``steps``, and every table cut to
``max_rows`` rows; every width stays as published.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch

from deeplearningrecommendationsystem_tpu_torch.models import dlrm
from deeplearningrecommendationsystem_tpu_torch.runtime import profiler
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.train import sparse
from deeplearningrecommendationsystem_tpu_torch.train.minibatch import epoch_order
from deeplearningrecommendationsystem_tpu_torch.train.sparse_trainer import fit_minibatch_sparse

from portbench import refcommon, spec, weights
from portbench.program import Setup, replaced, synchronize

NUMBERS = ("loss_gap", "grad_gap", "rows_gap", "dense_change_gap", "feed_mismatch")
# the program's spans whose device time a recorded unit reports, a step
SPANS = ("train.lookup", "dlrm.bags", "dlrm.cross", "train.sparse_update")
# the generator of the batches starts from the run's seed plus this
DATA_STREAM = 1 << 41


def cross_bias_outside():
    """The cross layer adds its bias outside the product with x0, as DCN's does."""
    def wrap(orig):
        def cross(layers, x0):
            x = x0
            for p in layers:
                x = x0 * ((x @ p["v"]) @ p["w"]) + p["b"] + x
            return x
        return cross
    return replaced(dlrm, "low_rank_cross", wrap)


def bag_last_id_dropped():
    """Every bag of more than one id leaves its last id out of its sum."""
    def wrap(orig):
        def pool(rows):
            return rows[:, :max(rows.shape[1] - 1, 1)].sum(dim=1)
        return pool
    return replaced(dlrm, "pool_bags", wrap)


def accumulator_unchanged():
    """Row-wise AdaGrad scales by the accumulator advanced by the step's
    gradient but never writes it back."""
    def wrap(orig):
        def adagrad(table, state, uids, ugrads, lr, eps=1e-10):
            kept = state.accum.clone()
            out = orig(table, state, uids, ugrads, lr, eps)
            state.accum.copy_(kept)
            return out
        return adagrad
    return replaced(sparse, "rowwise_adagrad", wrap)


FAULTS = {"cross_bias_outside": cross_bias_outside, "bag_last_id_dropped": bag_last_id_dropped,
          "accumulator_unchanged": accumulator_unchanged}


class Phases(Setup):
    """``Setup``'s timer of the set-up's steps (``phases``, ``phase``),
    without its ml-100k fixture, model and weights."""

    def __init__(self, device: torch.device):
        self.device = device
        self.phases: Dict[str, float] = {}


def draw_batches(config: Dict, traffic: Dict, heights: List[int], rows: int, seed: int,
                 device: torch.device):
    """``({"dense": [rows, 13], "ids": [rows, sum(hotness)]}, labels [rows])``
    drawn on ``device`` from ``seed`` (see the module's docstring)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed + DATA_STREAM)
    cols = []
    for v, h in zip(heights, config["multi_hot_sizes"]):
        w = torch.arange(1, v + 1, dtype=torch.float64, device=device) ** -traffic["zipf_a"]
        cdf = torch.cumsum(w, 0)
        u = torch.rand(rows, dtype=torch.float64, generator=g, device=device) * cdf[-1]
        rank = torch.searchsorted(cdf, u).clamp_(max=v - 1)
        first = torch.randperm(v, generator=g, device=device)[rank]
        offsets = torch.randint(0, v, (rows, h - 1), generator=g, device=device)
        cols.append(torch.cat([first[:, None], (first[:, None] + offsets) % v], dim=1))
    z = torch.randn((rows, config["num_dense_features"]), generator=g, device=device)
    counts = torch.floor(torch.exp(traffic["dense_log_mean"] + traffic["dense_log_std"] * z))
    labels = (torch.rand(rows, generator=g, device=device) < traffic["positive_rate"]).float()
    return {"dense": torch.log1p(counts), "ids": torch.cat(cols, dim=1)}, labels


class Cell:
    def __init__(self, env):
        self.env = env
        cfg, tr, dev = env.config, env.traffic, env.device
        if dev.type == "cuda":
            # one intra-op thread, as torchrun gives each worker of a node
            # (OMP_NUM_THREADS=1): on a loaded host a parallel region, such as
            # the epoch order's randperm fill, stalls while the card waits
            torch.set_num_threads(1)
        self.reference = spec.reference(cfg["model"])
        self.setup = s = Phases(dev)
        self.batch_size, self.steps = int(cfg["batch_size"]), int(tr["steps"])
        self.heights = self.reference.heights(cfg)
        if dev.type == "cpu":
            cpu = tr["cpu"]
            self.batch_size, self.steps = int(cpu["batch_size"]), int(cpu["steps"])
            self.heights = [min(v, int(cpu["max_rows"])) for v in self.heights]
            cfg = dict(cfg, **{f"cat_{f}": v for f, v in enumerate(self.heights)})
        self.config = cfg
        self.rows = self.batch_size * self.steps
        with s.phase("model"):
            bags = dlrm.BagSpec(tuple(self.heights), tuple(cfg["multi_hot_sizes"]))
            self.model = dlrm.DLRM(
                bags, cfg["embedding_dim"], cfg["num_dense_features"],
                cfg["dense_arch_layer_sizes"], cfg["over_arch_layer_sizes"],
                cfg["dcn_num_layers"], cfg["dcn_low_rank_dim"],
                generator=torch.Generator(device=dev).manual_seed(env.seed), device=dev)
            named = dict(self.model.named_parameters())
            self.table = named.pop("tables")
            self.reference.fill_tables(cfg, env.seed, [self.table.data[o:o + v] for o, v in
                                                       zip(bags.row_offsets, self.heights)])
            self.dense = named
            self.w0 = weights.draw(self.reference.dense_specs(cfg), env.seed, dev)
            shapes = {k: tuple(v.shape) for k, v in self.dense.items()}
            if shapes != {k: tuple(v.shape) for k, v in self.w0.items()}:
                raise ValueError(f"the model's dense leaves {shapes} differ from the reference's")
        with s.phase("batches"):
            self.batch, self.labels = draw_batches(cfg, tr, self.heights, self.rows, env.seed, dev)
            self.order = epoch_order(env.seed, self.rows, 1, self.batch_size)[0].to(dev)
        with s.phase("touched"):
            rows = self.model.table_ids(self.batch)["tables"]
            self.feed_mismatch = self.reference.ids_mismatch(cfg, rows, self.batch["ids"])
            self.touched = torch.unique(rows)  # every row a unit updates, of every table
            self.saved = self.table.detach()[self.touched]
            # the same rows by table, each table's own row numbers
            starts = torch.tensor(bags.row_offsets, device=dev)
            table_of = torch.bucketize(self.touched, starts, right=True) - 1
            self.touched_by_table = [self.touched[table_of == f] - o
                                     for f, o in enumerate(bags.row_offsets)]
            lookups = []
            for idx in self.order:
                step = self.model.table_ids({"ids": self.batch["ids"][idx]})["tables"]
                lookups.append([(int(step.numel()), int(torch.unique(step).numel()))])
            del rows, step
        with s.phase("costs"):
            self.costs = spec.costs(cfg["model"]).train_unit(cfg, self.rows, lookups)
        self.trainer = Trainer(self.model, TrainConfig(learning_rate=cfg["learning_rate"],
                                                       epochs=1), device=dev)
        self._restore()  # the dense leaves take the benchmark's weights
        with s.phase("checked_steps"):
            self.program = self._checked_steps(int(tr["checked_steps"]))
        self.histories: List[torch.Tensor] = []
        with s.phase("warmup"):
            self.unit(None)
        self.histories = []
        self._ref = None

    def _restore(self) -> None:
        with torch.no_grad():
            self.table.index_copy_(0, self.touched, self.saved)
            for k, p in self.dense.items():
                p.copy_(self.w0[k])

    def _fit(self, rows: torch.Tensor | None = None):
        """``fit_minibatch_sparse`` over the batch's ``rows`` (all of them by
        default), one epoch."""
        batch, labels = self.batch, self.labels
        if rows is not None:
            batch, labels = {k: v[rows] for k, v in batch.items()}, labels[rows]
        return fit_minibatch_sparse(self.trainer, self.env.seed, (batch, labels),
                                    self.batch_size, optimizer="rowwise_adagrad",
                                    step_losses=True)

    def _steps_of(self, batches: torch.Tensor) -> torch.Tensor:
        """The rows to give ``fit_minibatch_sparse`` so that its epoch runs
        ``batches`` [k, B], in order: its own shuffle undone."""
        perm = epoch_order(self.env.seed, batches.numel(), 1, self.batch_size)[0]
        rows = torch.empty_like(batches.reshape(-1))
        rows[perm.reshape(-1).to(rows.device)] = batches.reshape(-1)
        return rows

    def _checked_steps(self, k: int) -> Dict:
        """From the seed's weights, one step on the unit's first batch (its
        loss and dense gradient, from the Adam state after it), then the
        unit's first ``k`` steps (their losses, the touched rows and the
        dense leaves after them); each run restored after it."""
        res = self._fit(self._steps_of(self.order[:1]))
        b1 = refcommon.ADAM_BETAS[0]
        out = {"loss": float(res.history["step_loss"][0]),
               "first_grad": {n: (st["exp_avg"] / (1 - b1)).float().cpu()
                              for n, st in res.opt_state["dense"].items()}}
        del res  # its copy of every parameter, before the next run makes another
        self._restore()
        res = self._fit(self._steps_of(self.order[:k]))
        out["losses"] = res.history["step_loss"].tolist()
        with torch.no_grad():  # kept on the host: the card holds what training holds
            out["rows"] = [self.table.detach()[i + o].cpu() for i, o in
                           zip(self.touched_by_table, self.model.bags.row_offsets)]
            out["dense"] = {n: v.detach().cpu() for n, v in self.dense.items()}
        self._restore()
        return out

    def unit(self, spans) -> Dict[str, float]:
        self._restore()
        record = spans is not None and not profiler.is_recording()
        with profiler.recording() if record else contextlib.nullcontext() as rec:
            res = self._fit()
            synchronize(self.env.device)
        self.histories.append(res.history["step_loss"])
        work = {"rows": self.rows}
        if record:
            out = rec.export()
            for name in SPANS:
                ms = [x["device_ms"] for x in out["spans"] if x["name"] == name]
                if ms and None not in ms:
                    spans[name] = sum(ms) / 1e3 / self.steps
            work.update(ids=out["counters"].get("train.ids", 0),
                        rows_touched=out["counters"].get("train.rows_touched", 0))
        return work

    def release(self) -> None:
        """Keep the window's step losses on the host; free the program's state."""
        self.program["histories"] = [h.detach().float().cpu() for h in self.histories]
        self.histories = []
        self.trainer = self.model = self.table = self.dense = self.saved = None
        if self.env.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, precision: str) -> Dict:
        """The reference's first ``checked_steps`` steps of a unit, in ``precision``."""
        k = len(self.program["losses"])
        steps = [({n: v[i] for n, v in self.batch.items()}, self.labels[i]) for i in self.order[:k]]
        with refcommon.precision(precision, self.env.device) as mm:
            out = self.reference.train(mm, self.config, self.w0, self.env.seed, steps,
                                       self.config["learning_rate"], self.touched_by_table)
        out["first_grad"] = {n: g.float().cpu() for n, g in out["first_grad"].items()}
        if self.env.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def numbers(self, readings: Dict | None = None) -> Dict[str, float]:
        """The numbers compared: ``readings`` (the program's by default)
        against the reference's first ``checked_steps`` steps in float32.
        The worst relative gap of a step's loss, over set-up's one step and
        its checked steps and every window unit's first checked steps (inf
        where any step of a unit has a loss that is not finite); the worst
        dense leaf's first gradient (``refcommon.leaf_gaps``); the worst
        table's gap between the program's and the reference's changes of
        the touched rows over the checked steps, over the norm of the
        reference's; the same of each dense leaf that its first gradient
        moves (``refcommon.moved_leaves``), the worst; the ids that differ.
        Later steps are not compared: from the fifth step on, rounding's
        gaps grow about fivefold a step (PERF.md §2)."""
        if self._ref is None:
            self._ref = self._reference("float32")
        got = self.program if readings is None else readings
        ref = self._ref
        k = len(ref["losses"])
        self.unit_gaps = [refcommon.loss_gap(h[:k].tolist(), ref["losses"])
                          if bool(torch.isfinite(h).all()) else float("inf")
                          for h in got["histories"]]
        checked = [refcommon.loss_gap([got["loss"]], ref["losses"][:1]),
                   refcommon.loss_gap(got["losses"], ref["losses"])]
        grads = refcommon.leaf_gaps(got["first_grad"], ref["first_grad"])
        rows = [_change_gap(p.to(r.device), r, r0)
                for p, r, r0 in zip(got["rows"], ref["rows"], ref["rows0"])]
        moved = refcommon.moved_leaves(ref["first_grad"])
        dense = {n: _change_gap(got["dense"][n].to(self.w0[n].device), ref["dense"][n], self.w0[n])
                 for n in moved}
        self.leaves = {"grad_gap": grads, "dense_change_gap": dense,
                       "rows_gap": dict(enumerate(rows))}
        return {"loss_gap": max(checked + self.unit_gaps),
                "grad_gap": max(grads.values()),
                "rows_gap": max(rows),
                "dense_change_gap": max(dense.values()),
                "feed_mismatch": float(got.get("feed_mismatch", self.feed_mismatch))}

    def control(self, precision: str = "tf32") -> Dict[str, float]:
        """The numbers of the reference in ``precision`` put in the
        program's place: its steps as set-up's and as the one unit's, its
        first gradient, its rows and leaves, its own slicing."""
        low = self._reference(precision)
        readings = {"loss": low["losses"][0], "losses": low["losses"],
                    "first_grad": low["first_grad"], "histories": [torch.tensor(low["losses"])],
                    "rows": low["rows"], "dense": low["dense"], "feed_mismatch": 0}
        return self.numbers(readings)

    def attempted_failed(self, units: int, limits: Dict[str, float]):
        """Units run, and those whose checked step losses are out of their
        limit or whose losses are not all finite."""
        return units, sum(not (math.isfinite(g) and g <= limits["loss_gap"])
                          for g in self.unit_gaps)


def _change_gap(got: torch.Tensor, want: torch.Tensor, start: torch.Tensor) -> float:
    """The norm of the gap between two changes from ``start``, over the norm
    of the reference's change; inf where the program's is not finite."""
    gap = float((got - want).norm())
    if not math.isfinite(gap):
        return float("inf")
    return gap / max(float((want - start).norm()), 1e-30)

