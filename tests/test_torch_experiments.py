"""The MF slice end to end: ``run_experiment`` in both packages on one small
synthetic ml-100k-format dataset, and the port's ``cli/serve.py`` on the CPU.

Both runs are made to start from the same numbers: the port's
``NegativeSampler`` and ``build_model`` are replaced by ones that hand it the
JAX sampler's arrays and the JAX initial params (``jax.random`` cannot be
replayed in torch). Then the histories, the final params, the ranking dicts
and the served top-k lists are compared. Tolerances, float32: losses and
AUCs rtol 1e-5 (sums in another order); params atol 5e-5 (measured:
1.3e-5), since Adam's normalised step turns the rounding of a gradient sum
that nearly cancels into a weight change of up to lr times its relative
error; the checksum (a sum of 40k params and moments) atol 2e-4 (measured:
4.7e-5); the thresholded
metrics, the ranking metrics and the top-k lists exactly, since no two
scores of a user that decide a list lie closer than the packages' float32
differences on this data.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu import experiments as jax_experiments
from deeplearningrecommendationsystem_tpu.configs import PRESETS as JAX_PRESETS
from deeplearningrecommendationsystem_tpu.data import MovieLens100K as JaxMovieLens
from deeplearningrecommendationsystem_tpu.models import MatrixFactorization as JaxMF
from deeplearningrecommendationsystem_tpu.sampling import NegativeSampler as JaxSampler
from deeplearningrecommendationsystem_tpu.serving import Recommender as JaxRecommender
from deeplearningrecommendationsystem_tpu_torch import experiments
from deeplearningrecommendationsystem_tpu_torch.cli import serve
from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization
from deeplearningrecommendationsystem_tpu_torch.ops.serving_topk import topk_serve_matmul_plain
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

U, I, R, EPOCHS = 60, 150, 3000, 3
THRESHOLDED = ("accuracy", "precision", "recall", "f1", "auc")


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    return write_ml100k_format(str(tmp_path_factory.mktemp("ml")), seed=5,
                               num_users=U, num_items=I, num_ratings=R)


class _JaxDraws:
    """Stands in for the port's NegativeSampler: the JAX sampler's arrays."""

    def __init__(self, excluded, seed=0, device="cpu"):
        self._inner = JaxSampler(excluded, seed=seed)

    def sample(self, n):
        return {k: np.array(v) for k, v in self._inner.sample(n).items()}


def _jax_init_model(cfg, data, generator=None):
    params = JaxMF(data.num_users, data.num_items, **cfg.model_kwargs).init(
        jax.random.PRNGKey(cfg.seed))
    model = MatrixFactorization(data.num_users, data.num_items, **cfg.model_kwargs, device="cpu")
    return params_from_jax(model, {k: np.array(v) for k, v in params.items()})


@pytest.fixture(scope="module")
def runs(dataset_dir):
    mp = pytest.MonkeyPatch()
    mp.setattr(experiments, "NegativeSampler", _JaxDraws)
    mp.setattr(experiments, "build_model", _jax_init_model)
    try:
        jx = JaxMovieLens(dataset_dir, seed=0, use_native=False)
        pt = MovieLens100K(dataset_dir, seed=0)
        want = jax_experiments.run_experiment(JAX_PRESETS["mf"].replace(epochs=EPOCHS), data=jx)
        got = experiments.run_experiment(PRESETS["mf"].replace(epochs=EPOCHS), data=pt,
                                         device="cpu")
    finally:
        mp.undo()
    return got, want, jx, pt


def test_history_and_params_match_jax(runs):
    got, want, _, _ = runs
    assert got.train_examples == want.train_examples
    assert got.epochs == want.epochs == EPOCHS
    assert set(got.history) == set(want.history)
    for key, w in want.history.items():
        metric = key.split("_", 1)[1]
        if key == "_param_checksum":  # a sum of 40k values near -0.47
            np.testing.assert_allclose(got.history[key], w, atol=2e-4, err_msg=key)
        elif metric in THRESHOLDED:
            np.testing.assert_array_equal(got.history[key], w, err_msg=key)
        else:
            np.testing.assert_allclose(got.history[key], w, rtol=1e-5, err_msg=key)
    assert got.extras.keys() == want.extras.keys()
    for key in want.extras:
        np.testing.assert_allclose(got.extras[key], want.extras[key], rtol=1e-5, err_msg=key)
    for key in ("user", "item"):
        np.testing.assert_allclose(got.params[key].numpy(), np.asarray(want.params[key]),
                                   atol=5e-5, err_msg=key)
    assert got.final_metrics().keys() == want.final_metrics().keys()


def test_ranking_matches_jax(runs):
    got, want, _, _ = runs
    assert got.ranking.keys() == want.ranking.keys() == {"valid", "valid@10", "test", "test@10"}
    for split in want.ranking:
        assert got.ranking[split].keys() == want.ranking[split].keys()
        for m, w in want.ranking[split].items():
            np.testing.assert_allclose(got.ranking[split][m], w, rtol=1e-6, err_msg=f"{split} {m}")


def test_served_top_k_matches_jax(runs):
    got, want, jx, pt = runs
    model = MatrixFactorization(U, I, 64, device="cpu")
    model.load_state_dict(got.params)
    rec = Recommender(model, got.ctx, seen=pt.seen_mask(pt.train, pt.valid, pt.test), device="cpu")
    jax_rec = JaxRecommender(JaxMF(U, I, 64), want.params, want.ctx,
                             seen=jx.seen_mask(jx.train, jx.valid, jx.test), use_pallas=False)
    for k in (10, 50):
        np.testing.assert_array_equal(rec.top_k(k), jax_rec.top_k(k))


def test_other_presets_name_their_roadmap_item(dataset_dir):
    pt = MovieLens100K(dataset_dir, seed=0)
    for name in ("deepfm", "neuralcf", "din", "autorec", "lr"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            experiments.run_experiment(PRESETS[name].replace(epochs=1), data=pt, device="cpu")
    for over in ({"train_mode": "minibatch"}, {"mesh_shape": (1, 2)}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            experiments.run_experiment(PRESETS["mf"].replace(epochs=1, **over), data=pt,
                                       device="cpu")


def _args(dataset_dir, **over):
    args = serve.parser().parse_args(["--model", "mf", "--data", dataset_dir, "--epochs", "2",
                                      "--port", "0", "--device", "cpu"])
    return argparse.Namespace(**{**vars(args), **over})


def test_build_server_trains_and_serves(dataset_dir):
    server = serve.build_server(_args(dataset_dir))
    try:
        code, payload = server.dispatch("POST", "/v1/recommend", {"users": [0, 7, 59], "k": 10})
        assert code == 200
        rec = server.recommender
        P, Q = rec.model.serving_factors(rec.ctx)
        _, want = topk_serve_matmul_plain(P.detach()[[0, 7, 59]], Q.detach(), rec.seen[[0, 7, 59]],
                                          k=10)
        assert payload["items"] == want.tolist()
        assert not rec.seen[[0, 7, 59]].gather(1, want.long()).any()
        # the server's model is the one run_experiment trained from the same seed
        res = experiments.run_experiment(PRESETS["mf"].replace(epochs=2, track_metrics=False),
                                         data=MovieLens100K(dataset_dir, seed=0), device="cpu")
        torch.testing.assert_close(rec.model.user.detach(), res.params["user"], rtol=0, atol=0)
    finally:
        server.httpd.server_close()


@pytest.mark.parametrize("flag", ["checkpoint", "mesh"])
def test_build_server_unported_flags_exit(dataset_dir, flag):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        serve.build_server(_args(dataset_dir, **{flag: "x"}))
