"""MF, the feature family, DIEN, NeuralCF and both AutoRecs end to end:
``run_experiment`` in both packages on small synthetic ml-100k-format
datasets, in full-batch mode and, for MF and DeepFM, in the minibatch,
stream and sparse training modes, and the port's ``cli/serve.py`` on the CPU.

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
differences on this data. The feature presets (LR, and AFM, DeepFM,
WideDeep, NFM, PNN, DCN, DeepCrossing and FFM narrowed through
``model_kwargs``: embeddings 8-32, towers of two or three layers) run on a
dataset with 300 items, since on 150 the sampler can emit item id I,
which the 45-column feature matrix cannot look up in either package
(``ROADMAP.md`` §3); held to the same tolerances, except AFM's checksum
(rtol 1e-5: its standard-normal attention weights make it a sum of values
near 100).
"""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu import experiments as jax_experiments
from deeplearningrecommendationsystem_tpu.configs import PRESETS as JAX_PRESETS
from deeplearningrecommendationsystem_tpu.data import MovieLens100K as JaxMovieLens
from deeplearningrecommendationsystem_tpu.features import FeatureSpec as JaxSpec
from deeplearningrecommendationsystem_tpu import models as jax_models
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
from deeplearningrecommendationsystem_tpu_torch.train import minibatch
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax
from jax_order import jax_order

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


def _jax_init_model(cfg, data, generator=None, key=None):
    key = jax.random.PRNGKey(cfg.seed) if key is None else key
    params = JaxMF(data.num_users, data.num_items, **cfg.model_kwargs).init(key)
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


# ---- the feature family: LR, and narrow AFM, DeepFM, WideDeep, NFM, PNN, DCN,
# DeepCrossing and FFM

FEATURE_I = 300
_TOWER = {"hidden_units": (32, 16, 1), "embedding_dim": 16}
FEATURE_CONFIGS = {
    "lr": {}, "afm": {"model_kwargs": {"embedding_dim": 32, "attention_dim": 16}},
    "deepfm": {"model_kwargs": _TOWER}, "widedeep": {"model_kwargs": _TOWER},
    "nfm": {"model_kwargs": _TOWER},
    "pnn": {"model_kwargs": {"embedding_dim": 16, "hidden_units": (32, 16, 8)}},
    "deepcross": {"model_kwargs": {"cross_layers": 3, "deep_hidden_units": (32, 16, 1),
                                   "embedding_dim": 8}},
    "deepcrossing": {"model_kwargs": {"embedding_dim": 8, "hidden_units": (32, 16)}},
    "ffm": {"model_kwargs": {"num_vector": 8}},
}
# the JAX class of each feature preset (the JAX package's experiments.py::build_model)
JAX_FEATURE_MODELS = {"lr": "LogisticRegression", "afm": "AFM", "deepfm": "DeepFM",
                      "widedeep": "WideDeep", "nfm": "NFM", "pnn": "PNN", "deepcross": "DCN",
                      "deepcrossing": "DeepCrossing", "ffm": "FFM"}
_build_model = experiments.build_model


@pytest.fixture(scope="module")
def feature_dir(tmp_path_factory):
    return write_ml100k_format(str(tmp_path_factory.mktemp("mlf")), seed=5, num_users=U,
                               num_items=FEATURE_I, num_ratings=R)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, (list, tuple)):
            v = {str(i): layer for i, layer in enumerate(v)}
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _jax_init_feature_model(cfg, data, generator=None, key=None):
    key = jax.random.PRNGKey(cfg.seed) if key is None else key
    jax_model = getattr(jax_models, JAX_FEATURE_MODELS[cfg.model])(
        JaxSpec(**dataclasses.asdict(data.spec)), **cfg.model_kwargs)
    params = jax.tree.map(np.asarray, jax_model.init(key))
    return params_from_jax(_build_model(cfg, data), params)


@pytest.fixture(scope="module", params=list(FEATURE_CONFIGS))
def feature_runs(request, feature_dir):
    name = request.param
    over = dict(epochs=EPOCHS, **FEATURE_CONFIGS[name])
    mp = pytest.MonkeyPatch()
    mp.setattr(experiments, "NegativeSampler", _JaxDraws)
    mp.setattr(experiments, "build_model", _jax_init_feature_model)
    try:
        jx = JaxMovieLens(feature_dir, seed=0, use_native=False)
        pt = MovieLens100K(feature_dir, seed=0)
        want = jax_experiments.run_experiment(JAX_PRESETS[name].replace(**over), data=jx)
        got = experiments.run_experiment(PRESETS[name].replace(**over), data=pt, device="cpu")
    finally:
        mp.undo()
    return name, got, want


def test_feature_history_and_params_match_jax(feature_runs):
    name, got, want = feature_runs
    assert got.model == name and got.train_examples == want.train_examples
    assert set(got.history) == set(want.history)
    for key, w in want.history.items():
        metric = key.split("_", 1)[1]
        if key == "_param_checksum":
            tol = {"rtol": 1e-5} if name == "afm" else {"atol": 2e-4}
            np.testing.assert_allclose(got.history[key], w, err_msg=key, **tol)
        elif metric in THRESHOLDED:
            np.testing.assert_array_equal(got.history[key], w, err_msg=key)
        else:
            np.testing.assert_allclose(got.history[key], w, rtol=1e-5, err_msg=key)
    for key in want.extras:
        np.testing.assert_allclose(got.extras[key], want.extras[key], rtol=1e-5, err_msg=key)
    want_params = _flat(jax.tree.map(np.asarray, want.params))
    assert got.params.keys() == want_params.keys()
    for key, w in want_params.items():
        np.testing.assert_allclose(got.params[key].numpy(), w, atol=5e-5, err_msg=key)


def test_feature_ranking_matches_jax(feature_runs):
    _, got, want = feature_runs
    assert got.ranking.keys() == want.ranking.keys()
    for split in want.ranking:
        for m, w in want.ranking[split].items():
            np.testing.assert_allclose(got.ranking[split][m], w, rtol=1e-6, err_msg=f"{split} {m}")


def test_other_presets_name_their_roadmap_item(dataset_dir):
    """Every preset is ported now: none names a ROADMAP.md item, and each
    builds its model; the refusals that remain are the training modes and the
    mesh (``test_unported_modes_name_their_roadmap_item``)."""
    pt = MovieLens100K(dataset_dir, seed=0)
    assert experiments._NOT_PORTED == {}
    assert set(experiments.FAMILIES) == {cfg.family for cfg in PRESETS.values()}
    for name, cfg in PRESETS.items():
        assert isinstance(experiments.build_model(cfg, pt), torch.nn.Module), name


@pytest.mark.parametrize("over", [{"train_mode": "minibatch"}, {"train_mode": "sparse"},
                                  {"train_mode": "stream"}, {}],
                         ids=["minibatch", "sparse", "stream", "mesh"])
def test_unported_modes_name_their_roadmap_item(dataset_dir, over):
    """Every training mode is ported; a mesh, in any mode, is laid over the
    ranks of a process group (``tests/test_torch_parallel.py``), and without
    one raises, naming the call that makes it."""
    pt = MovieLens100K(dataset_dir, seed=0)
    with pytest.raises(RuntimeError, match="no process group.*initialize"):
        experiments.run_experiment(PRESETS["mf"].replace(epochs=1, mesh_shape=(1, 2), **over),
                                   data=pt, device="cpu")


# ---- the training modes: MF in minibatch, stream and sparse mode (both row
# optimizers) and a narrow DeepFM in sparse mode, against the JAX package's
# run_experiment from the same weights and negatives, each epoch's order
# replayed from the JAX run (the stream order is NumPy's in both)

MODE_BATCH = 1024
MODES = {
    "minibatch": ("mf", {"train_mode": "minibatch"}),
    "stream": ("mf", {"train_mode": "stream"}),
    "sparse_lazy_adam": ("mf", {"train_mode": "sparse"}),
    "sparse_rowwise_adagrad": ("mf", {"train_mode": "sparse",
                                      "sparse_optimizer": "rowwise_adagrad"}),
    "deepfm_sparse": ("deepfm", {"train_mode": "sparse", "model_kwargs": _TOWER}),
}


@pytest.mark.parametrize("case", list(MODES))
def test_train_modes_match_jax(dataset_dir, feature_dir, monkeypatch, case):
    name, over = MODES[case]
    over = dict(over, epochs=2, batch_size=MODE_BATCH)
    path = feature_dir if name == "deepfm" else dataset_dir
    rng = jax.random.PRNGKey(0)  # the JAX run_experiment's, cfg.seed 0
    # the JAX minibatch trainers draw the initial params from split(rng)[0]
    # (fit_stream, as Trainer.fit, from rng itself)
    init_key = rng if over["train_mode"] == "stream" else jax.random.split(rng)[0]
    monkeypatch.setattr(experiments, "NegativeSampler", _JaxDraws)
    monkeypatch.setattr(experiments, "build_model", functools.partial(
        _jax_init_feature_model if name == "deepfm" else _jax_init_model, key=init_key))
    monkeypatch.setattr(minibatch, "epoch_order", jax_order(rng))
    jx = JaxMovieLens(path, seed=0, use_native=False)
    want = jax_experiments.run_experiment(JAX_PRESETS[name].replace(**over), data=jx)
    got = experiments.run_experiment(PRESETS[name].replace(**over), data=MovieLens100K(path, seed=0),
                                     device="cpu")
    assert set(got.history) == set(want.history) == {"train_loss"}
    np.testing.assert_allclose(got.history["train_loss"], want.history["train_loss"], rtol=1e-5)
    want_params = _flat(jax.tree.map(np.asarray, want.params))
    assert got.params.keys() == want_params.keys()
    for key, w in want_params.items():
        np.testing.assert_allclose(got.params[key].numpy(), w, atol=5e-5, err_msg=key)
    assert got.ranking.keys() == want.ranking.keys()
    for split in want.ranking:
        for m, w in want.ranking[split].items():
            np.testing.assert_allclose(got.ranking[split][m], w, rtol=1e-6, err_msg=f"{split} {m}")
    assert got.final_metrics().keys() == want.final_metrics().keys()


def test_sparse_mode_needs_the_protocol(feature_dir):
    pt = MovieLens100K(feature_dir, seed=0)
    with pytest.raises(TypeError, match="sparse-table protocol"):
        experiments.run_experiment(PRESETS["lr"].replace(epochs=1, train_mode="sparse"), data=pt,
                                   device="cpu")
    with pytest.raises(ValueError, match="unknown train_mode"):
        experiments.run_experiment(PRESETS["mf"].replace(train_mode="online"), data=pt,
                                   device="cpu")


# ---- the last four presets: DIEN (seq), NeuralCF (pair), AutoRec and I-AutoRec
# (matrix), narrowed through model_kwargs

NEW_CONFIGS = {
    "dien": {"model_kwargs": {"embed_size": 8, "attention_units": (16, 8, 1),
                              "fc_units": (32, 16, 1)}},
    "dien_augru_aux": {"model_kwargs": {"embed_size": 8, "attention_units": (16, 8, 1),
                                        "fc_units": (32, 16, 1), "use_augru": True},
                       "aux_weight": 0.5, "full_history_serving": False},
    "dien_aux": {"model_kwargs": {"embed_size": 8, "attention_units": (16, 8, 1),
                                  "fc_units": (32, 16, 1)},
                 "aux_weight": 0.5, "full_history_serving": False},
    "dien_augru": {"model_kwargs": {"embed_size": 8, "attention_units": (16, 8, 1),
                                    "fc_units": (32, 16, 1), "use_augru": True},
                   "full_history_serving": False},
    "neuralcf": {"model_kwargs": {"mf_dim": 16, "layers": (32, 16, 8)}},
    "autorec": {"model_kwargs": {"hidden_units": 16}},
    "i-autorec": {"model_kwargs": {"hidden_units": 16}},
}


@pytest.fixture
def one_thread():
    """One intra-op thread a test, for the tests of the last four presets:
    DIEN's GRU is many small ops, for which threads buy nothing alone and,
    with several test workers on one host, each worker's thread pool spinning
    against the others' made these tests ten times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


JAX_NEW_MODELS = {"dien": "DIEN", "neuralcf": "NeuralCF", "autorec": "AutoRec",
                  "i-autorec": "AutoRec"}


def _jax_init_new_model(cfg, data, generator=None):
    U, I = data.num_users, data.num_items
    jax_cls = getattr(jax_models, JAX_NEW_MODELS[cfg.model])
    args = {"dien": (I,), "neuralcf": (U, I), "autorec": (I,), "i-autorec": (U,)}[cfg.model]
    params = jax.tree.map(np.asarray, jax_cls(*args, **cfg.model_kwargs).init(
        jax.random.PRNGKey(cfg.seed)))
    return params_from_jax(_build_model(cfg, data), params)


def _new_run(case, dataset_dir, feature_dir):
    """The case in both packages. AutoRec and I-AutoRec take the 300-item
    dataset: their 150 global negatives a user would leave a user of the
    150-item one with no item to draw, where the JAX sampler emits item id I,
    which its rating matrix cannot hold (the sampler's known edge, as for the
    feature family). Their global negatives are the JAX sampler's draws too."""
    name = case.split("_")[0]
    over = dict(epochs=EPOCHS, **NEW_CONFIGS[case])
    path = feature_dir if name in ("autorec", "i-autorec") else dataset_dir
    mp = pytest.MonkeyPatch()
    mp.setattr(experiments, "NegativeSampler", _JaxDraws)
    mp.setattr(experiments, "build_model", _jax_init_new_model)
    try:
        jx = JaxMovieLens(path, seed=0, use_native=False)
        pt = MovieLens100K(path, seed=0)
        want = jax_experiments.run_experiment(JAX_PRESETS[name].replace(**over), data=jx)
        got = experiments.run_experiment(PRESETS[name].replace(**over), data=pt, device="cpu")
    finally:
        mp.undo()
    return name, got, want, pt


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("case", list(NEW_CONFIGS))
def test_new_presets_match_jax(case, dataset_dir, feature_dir):
    """DIEN in parity mode with full-history serving; DIEN with the auxiliary
    loss, AUGRU, or both (window serving, for the run's time); NeuralCF;
    AutoRec and I-AutoRec. Histories, params and ranking against JAX's
    ``run_experiment``, at the tolerances of the module docstring, except:
    the checksum atol 2e-4 and rtol 1e-5 (AutoRec's is a sum far from 0); the
    thresholded metrics atol 1e-3 and the raw AUCs atol 1e-4, the ranking
    metrics atol 1e-5, since after 3 epochs at lr 1e-3 the logits sit near 0:
    a probability within float32 rounding of 0.5 may fall on the other side
    (NeuralCF's third epoch: one train example of 5,373, accuracy 1.9e-4
    apart) and nearly equal scores may swap places (DIEN's raw AUC 7.2e-6
    apart), as ``tests/test_torch_din.py`` states for DIN."""
    name, got, want, pt = _new_run(case, dataset_dir, feature_dir)
    assert got.model == name and got.train_examples == want.train_examples
    assert set(got.history) == set(want.history)
    for key, w in want.history.items():
        metric = key.split("_", 1)[1]
        if key == "_param_checksum":
            np.testing.assert_allclose(got.history[key], w, atol=2e-4, rtol=1e-5, err_msg=key)
        elif metric in THRESHOLDED:
            np.testing.assert_allclose(got.history[key], w, rtol=0, atol=1e-3, err_msg=key)
        else:
            np.testing.assert_allclose(got.history[key], w, rtol=1e-5, err_msg=key)
    for key in want.extras:
        np.testing.assert_allclose(got.extras[key], want.extras[key], atol=1e-4, err_msg=key)
    want_params = _flat(jax.tree.map(np.asarray, want.params))
    assert got.params.keys() == want_params.keys()
    for key, w in want_params.items():
        np.testing.assert_allclose(got.params[key].numpy(), w, atol=5e-5, err_msg=key)

    assert got.ranking.keys() == want.ranking.keys() == {"valid", "valid@10", "test", "test@10"}
    for split in want.ranking:
        assert got.ranking[split].keys() == want.ranking[split].keys()
        for m, w in want.ranking[split].items():
            np.testing.assert_allclose(got.ranking[split][m], w, rtol=1e-6, atol=1e-5,
                                       err_msg=f"{split} {m}")
    if name in ("autorec", "i-autorec"):  # the rating matrix the model was served from
        U, I = pt.num_users, pt.num_items
        assert tuple(got.ctx.rating_matrix.shape) == ((I, U) if name == "i-autorec" else (U, I))
    if name == "dien":
        assert (got.ctx.full_histories is not None) == (case == "dien")


def test_matrix_split_and_aux_negatives_are_the_jax_draws(dataset_dir):
    """The 60/20/20 row split and DIEN's auxiliary negatives are NumPy draws
    in both packages: the same numbers."""
    for n, seed in ((943, 0), (1682, 3), (60, 7)):
        for a, b in zip(experiments.split_rows_60_20_20(n, seed),
                        jax_experiments._split_rows_60_20_20(n, seed)):
            np.testing.assert_array_equal(a, b)
    pt = MovieLens100K(dataset_dir, seed=0)
    cfg = PRESETS["dien"].replace(aux_weight=1.0)
    batches = experiments.split_batches(cfg, pt, "cpu")
    hist, target, neg = batches["train"][0]
    assert neg.shape == hist.shape
    excluded = pt.seen_mask(pt.train, pt.valid, pt.test)
    combined = MovieLens100K.concat_splits(pt.train, experiments.NegativeSampler(
        excluded, seed=cfg.seed, device="cpu").sample(cfg.negatives[0]))
    users = combined["user"]
    np.testing.assert_array_equal(neg.numpy(), experiments.aux_negatives(cfg, pt, users, excluded))
    rng = np.random.default_rng(cfg.seed + 17)  # the JAX package's draw, first round
    first = rng.integers(0, pt.num_items, (len(users), cfg.hist_len))
    kept = ~excluded[users[:, None], first]
    np.testing.assert_array_equal(neg.numpy()[kept], first[kept])
    assert not excluded[users[:, None], neg.numpy()].all()


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
    """``--mesh``, alone or with ``--checkpoint``, runs only under ``torchrun``
    and exits with a message in one process, before training (the sharded
    server on its ranks: ``tests/test_torch_runtime.py``; a checkpoint alone is
    served, ``tests/test_torch_checkpoint.py``)."""
    flags = {"mesh": "1,2", **({"checkpoint": "x"} if flag == "checkpoint" else {})}
    with pytest.raises(SystemExit, match="no process group"):
        serve.build_server(_args(dataset_dir, **flags))


@pytest.mark.parametrize("name", ["lr", "afm", "deepfm"])
def test_build_server_serves_feature_models(feature_dir, name):
    """LR serves through its rank-2 factors (the fused top-k at D = 2), AFM and
    DeepFM (the presets' full widths) through their masked catalog scores; every
    answer equals the stable top-k of the trained model's masked scores."""
    args = _args(feature_dir, model=name, epochs=2)
    server = serve.build_server(args)
    try:
        code, payload = server.dispatch("POST", "/v1/recommend", {"users": [0, 7, 59], "k": 10})
        assert code == 200
        rec = server.recommender
        assert hasattr(rec.model, "serving_factors") == (name == "lr")
        with torch.no_grad():
            masked = torch.where(rec.seen, -1e30, rec.model.score_catalog(rec.ctx))
        order = sorted(range(FEATURE_I), key=lambda i: (-masked[7, i].item(), i))
        assert payload["items"][1] == order[:10]
        if name == "lr":
            P, Q = rec.model.serving_factors(rec.ctx)
            assert P.shape[1] == Q.shape[1] == 2
    finally:
        server.httpd.server_close()


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", ["neuralcf", "autorec", "i-autorec", "dien"])
def test_build_server_serves_pair_matrix_and_seq_models(feature_dir, name):
    """NeuralCF (its pair catalog), AutoRec and I-AutoRec (from the rating
    matrix ``run_experiment`` left in the context) and DIEN (full histories)
    at their presets' full widths: every answer equals the stable top-k of
    the trained model's masked scores, with no seen item, and a fused
    recommender (``topk_scores``' plain version here) gives the same lists."""
    args = _args(feature_dir, model=name, epochs=1)
    server = serve.build_server(args)
    try:
        code, payload = server.dispatch("POST", "/v1/recommend", {"users": [0, 7, 59], "k": 10})
        assert code == 200
        rec = server.recommender
        if name.endswith("autorec"):
            assert rec.ctx.rating_matrix is not None
            assert tuple(rec.ctx.rating_matrix.shape[::-1 if name == "i-autorec" else 1]) == (
                U, FEATURE_I)
        with torch.no_grad():
            masked = torch.where(rec.seen, -1e30, rec.model.score_catalog(rec.ctx))
        for row, u in enumerate((0, 7, 59)):
            order = sorted(range(FEATURE_I), key=lambda i: (-masked[u, i].item(), i))
            assert payload["items"][row] == order[:10]
            assert not rec.seen[u, payload["items"][row]].any()
        fused = Recommender(rec.model, rec.ctx, seen=rec.seen, use_pallas="fused", device="cpu")
        np.testing.assert_array_equal(fused.top_k(10, [0, 7, 59]), np.array(payload["items"]))
    finally:
        server.httpd.server_close()
