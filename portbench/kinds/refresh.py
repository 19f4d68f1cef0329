"""Catalog refresh: the kind of traffic of a service that re-ranks every user
after a model update.

A unit of work is ``Recommender.refresh()`` (the whole catalog scored by the
model's catalog scorer, the seen items masked) and then ``top_k(k)`` for
every user, the lists on the host. The model holds the seed's weights; set-up
builds the serving context as ``experiments.run_experiment`` does, the seen
mask as ``cli/serve.py`` does (every rated item), and runs one unit to warm
up.

Every unit's lists are kept. Once the window has closed, the plain reference
scores the whole catalog for a sample of users drawn from the seed (with the
user of the longest history in it), from the fixture as the benchmark parsed
it (``feed``), and every unit's lists of those users, and the last unit's
scores, are held against it; so are the serving context's inputs (the
feature blocks, the complete histories) against the benchmark's.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from deeplearningrecommendationsystem_tpu_torch.models import ServingContext
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender

from portbench import refcommon
from portbench.program import Setup, replaced, synchronize

NUMBERS = ("score_gap", "list_gap", "feed_mismatch")


def answer_altered():
    """One answer is altered where it is produced: the first item of the
    first user's list becomes that user's lowest-scored item."""
    def wrap(orig):
        def top_k(self, k, users=None):
            out = orig(self, k, users).copy()
            out[0, 0] = int(torch.argmin(self.scores[0]))
            return out
        return top_k
    return replaced(Recommender, "top_k", wrap)


def half_users():
    """A refresh leaves out half of the users, whose scores stay 0."""
    def wrap(orig):
        def refresh(self):
            orig(self)
            self._scores[self._scores.shape[0] // 2:] = 0.0
        return refresh
    return replaced(Recommender, "refresh", wrap)


# the faults a refresh cell can have on one card, planted in the program
FAULTS = {"answer_altered": answer_altered, "half_users": half_users}


class Cell:
    def __init__(self, env):
        self.env = env
        self.setup = s = Setup(env.config, env.seed, env.device)
        data, cfg, dev = s.data, s.cfg, env.device
        with s.phase("context"):
            ctx = ServingContext(user_features=torch.from_numpy(data.user_features).to(dev),
                                 item_features=torch.from_numpy(data.item_features).to(dev))
            if cfg.family == "seq":
                ctx.history = torch.from_numpy(data.history_matrix(data.data, cfg.hist_len)).to(dev)
                if cfg.full_history_serving:
                    ctx.full_histories = [row[row >= 0] for row in data.itemid_matrix(data.data)]
            seen = data.seen_mask(data.train, data.valid, data.test)
            self.rec = Recommender(s.model, ctx, seen=seen, device=dev)
        self.ctx = ctx
        self.k = int(env.traffic["k"])
        self.inputs = s.reference_inputs()
        self.costs = s.costs.refresh(env.config, self.inputs)
        self.users = self._check_users(int(env.traffic["check_users"]))
        self.lists: List[np.ndarray] = []
        with s.phase("warm_up"):
            self.unit(None)
        self.lists.clear()

    def _check_users(self, n: int) -> np.ndarray:
        """``n`` users drawn from the seed, and the user with the most ratings."""
        num_users = self.inputs["num_users"]
        rng = np.random.default_rng(self.env.seed)
        pick = rng.choice(num_users, size=min(n, num_users), replace=False)
        longest = np.bincount(self.inputs["users"], minlength=num_users).argmax()
        return np.unique(np.append(pick, longest))

    def unit(self, spans) -> Dict[str, float]:
        t0 = time.perf_counter()
        self.rec.refresh()
        if spans is not None:
            synchronize(self.env.device)
            t1 = time.perf_counter()
            spans["refresh"] = t1 - t0
        lists = self.rec.top_k(self.k)
        if spans is not None:
            spans["top_k"] = time.perf_counter() - t1
        self.lists.append(lists)
        return {"lists": lists.shape[0]}

    def release(self) -> None:
        """Keep the last unit's scores of the checked users; free the program."""
        self.scores = self.rec.scores[torch.as_tensor(self.users, device=self.env.device)].cpu()
        self.rec = None
        self.setup.model = None
        self.feed_mismatch = self.setup.reference.serving_mismatch(self.setup.raw, self.ctx)
        self.ctx = None
        if self.env.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, precision: str) -> torch.Tensor:
        """The reference's scores of the checked users, seen items at -inf."""
        s, env = self.setup, self.env
        with refcommon.precision(precision, env.device) as mm:
            scores = s.reference.catalog_scores(mm, env.config, s.weights, self.inputs,
                                                self.users.tolist()).cpu()
        users, items = self.inputs["users"], self.inputs["items"]
        row = {u: r for r, u in enumerate(self.users.tolist())}
        keep = np.isin(users, self.users)
        r = torch.as_tensor([row[u] for u in users[keep]], dtype=torch.int64)
        scores[r, torch.as_tensor(items[keep], dtype=torch.int64)] = float("-inf")
        return scores

    def numbers(self, scores: torch.Tensor | None = None, lists: List[np.ndarray] | None = None,
                feed_mismatch: int | None = None) -> Dict[str, float]:
        """The numbers compared: the scores (the last unit's by default) and
        every unit's lists, of the checked users, against the reference's in
        float32, both against the reference's largest unseen score; and the
        serving inputs that differ from the benchmark's."""
        scores = self.scores if scores is None else scores
        lists = self.lists if lists is None else lists
        feed_mismatch = self.feed_mismatch if feed_mismatch is None else feed_mismatch
        ref = self._reference("float32")
        scale = float(ref[torch.isfinite(ref)].abs().max())
        top = torch.topk(ref, self.k, dim=1).values
        gaps = [refcommon.list_gap(torch.as_tensor(np.asarray(x)[self.users]), ref, top, scale)
                for x in lists]
        self.unit_gaps = gaps
        return {"score_gap": refcommon.score_gap(scores, ref, scale),
                "list_gap": max(gaps) if gaps else float("inf"),
                "feed_mismatch": float(feed_mismatch)}

    def control(self, precision: str = "tf32") -> Dict[str, float]:
        """The numbers of the reference in ``precision`` put in the program's
        place: its scores, and its lists by a stable sort of them."""
        low = self._reference(precision)
        masked = torch.where(torch.isfinite(low), low, torch.full_like(low, -1e30))
        idx = torch.sort(masked, dim=1, descending=True, stable=True).indices[:, :self.k]
        full = np.zeros((self.inputs["num_users"], self.k), dtype=np.int64)
        full[self.users] = idx.numpy()
        return self.numbers(masked, [full], 0)

    def attempted_failed(self, units: int, limits: Dict[str, float]):
        """Units run, and those whose lists were out of ``list_gap``'s limit."""
        return units, sum(not g <= limits["list_gap"] for g in self.unit_gaps)
