"""The port's parallel layer (``parallel/``, the Trainer's and the
experiment runner's mesh) on Gloo ranks on the CPU, against the JAX package
on the 8-device CPU mesh of ``tests/conftest.py`` with a JAX mesh of the same
shape.

Each case spawns its ranks once (``runtime/distributed.py::spawn``, a
module-scoped fixture, a deadline a spawn) through the port-only functions
of ``tests/torch_ranks.py``; the JAX side runs in this process.

* the collectives and their transposes: sums, tiled gathers and
  reduce-scatters against NumPy, exactly, and the bytes they count;
* the sharded lookups, bit for bit: ``sharded_gather`` and
  ``sharded_gather_scatter`` rows and table gradients against the JAX
  functions and the dense gather, on 2 and 4 ranks; ``shard_table``'s padding
  of 943 and 1682 rows over 2 and 4; the ``unshard_model_tables`` round trip;
  one gather and one ``onehot_grad`` call a lookup a rank;
* the Trainer on meshes (2, 1), (1, 2) under ``psum`` and ``scatter``, and
  (2, 2), MF and DeepFM for 3 epochs from the JAX init's weights (carried
  across with ``weights.py``): the losses within 1e-6 relative of the JAX
  Trainer's on the same mesh (the train loss: the JAX side runs without the
  per-epoch metrics, which multiply its compile time on a mesh tenfold), the
  final params within 1e-5 relative (of the
  model's largest parameter: a bias near 0 after three Adam steps already
  differs by 2e-7 between the packages on one device, where the mesh changes
  nothing on either side), and within 1e-5 of each tensor's largest
  magnitude of the port's own run on one rank (the data axis sums the
  gradients in another order, and Adam's first steps magnify that where a
  gradient nearly cancels), whose every history key (the valid and test
  losses and metrics, gathered from the ranks) and AUC the mesh run matches
  within 1e-6 relative; every rank's params the same
  bits, and the lookups a rank counted exactly;
* ``run_experiment(mesh_shape=(2, 2))`` for MF and DeepFM on 4 ranks against
  the JAX package's on a (2, 2) mesh of the same data, draws and weights:
  losses within 1e-6 relative, params within 1e-5 of the model's largest,
  ranking within 1e-6;
* sparse mode on a (1, 2) mesh, lazy Adam and row-wise AdaGrad, tables left
  sharded and gathered back, and stream mode on (2, 1), against the same
  calls on one rank.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from deeplearningrecommendationsystem_tpu import experiments as jax_experiments
from deeplearningrecommendationsystem_tpu import parallel as jax_parallel
from deeplearningrecommendationsystem_tpu.configs.presets import PRESETS as JAX_PRESETS
from deeplearningrecommendationsystem_tpu.data import MovieLens100K as JaxMovieLens
from deeplearningrecommendationsystem_tpu.features import FeatureSpec as JaxSpec
from deeplearningrecommendationsystem_tpu.models import DIEN as JaxDIEN
from deeplearningrecommendationsystem_tpu.models import DeepFM as JaxDeepFM
from deeplearningrecommendationsystem_tpu.models import MatrixFactorization as JaxMF
from deeplearningrecommendationsystem_tpu.parallel.embedding import (
    shard_table as jax_shard_table,
)
from deeplearningrecommendationsystem_tpu.parallel.embedding import (
    sharded_gather as jax_sharded_gather,
)
from deeplearningrecommendationsystem_tpu.parallel.embedding import (
    sharded_gather_scatter as jax_sharded_gather_scatter,
)
from deeplearningrecommendationsystem_tpu.sampling import NegativeSampler as JaxSampler
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu_torch.data.synthetic import write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.runtime.distributed import spawn
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer

import torch_ranks

DEADLINE_S = 120.0
U, I, EPOCHS, LR, WD = 30, 41, 3, 0.01, 1e-5
SIZES = {"train": 203, "valid": 61, "test": 57}
KWARGS = {"mf": {"embedding_dim": 8},
          "deepfm": {"hidden_units": (16, 8, 1), "embedding_dim": 8, "robust_init": True}}
MESHES = {"2x1": ((2, 1), "psum"), "1x2": ((1, 2), "psum"), "1x2_scatter": ((1, 2), "scatter"),
          "2x2": ((2, 2), "psum")}
# lookups a forward: MF's two tables; DeepFM's user and item tables and bias tables
LOOKUPS = {"mf": 2, "deepfm": 4}


def jax_mesh(data, model):
    return jax_parallel.make_mesh(data=data, model=model, devices=jax.devices()[:data * model])


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-30)))


def scaled_err(got, want) -> float:
    """The largest difference over the tensor's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def model_scaled_errs(got, want):
    """Each tensor's largest difference over the model's largest magnitude."""
    top = max(float(np.max(np.abs(w))) for w in want.values())
    return {n: float(np.max(np.abs(np.asarray(got[n], np.float64) - w))) / top
            for n, w in want.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, (list, tuple)):
            v = {str(i): layer for i, layer in enumerate(v)}
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def _features(rng, n, users=U, items=I):
    x = np.zeros((n, 45), np.float32)
    x[:, 0] = rng.integers(0, users, n)
    x[:, 1] = rng.integers(0, items, n)
    x[:, 2] = rng.random(n)
    x[np.arange(n), 3 + rng.integers(0, 2, n)] = 1
    x[np.arange(n), 5 + rng.integers(0, 21, n)] = 1
    x[:, 26:] = rng.random((n, 19)) < 0.2
    return x


# ---- the collectives ------------------------------------------------------


def test_collectives_and_their_transposes():
    out = spawn(torch_ranks.collectives_rank, 2, deadline_s=DEADLINE_S)
    xs = [np.arange(6, dtype=np.float32).reshape(3, 2) + 10 * r for r in range(2)]
    for r, o in enumerate(out):
        assert o["shape"] == {"data": 1, "model": 2}
        np.testing.assert_array_equal(o["sum"], xs[0] + xs[1])
        np.testing.assert_array_equal(o["gather"], np.concatenate(xs))
        full = sum(np.arange(4, dtype=np.float32) + q for q in range(2))
        np.testing.assert_array_equal(o["scatter"], full[2 * r:2 * r + 2])
        ws = [np.arange(6, dtype=np.float32).reshape(3, 2) + 100 * q for q in range(2)]
        # psum's backward is the identity: this rank's own cotangent, not the sum
        np.testing.assert_array_equal(o["grad_psum"], ws[r])
        # all_gather's is the reduce-scatter of the cotangents
        wg = [np.arange(12, dtype=np.float32).reshape(6, 2) + 100 * q for q in range(2)]
        np.testing.assert_array_equal(o["grad_all_gather"], (wg[0] + wg[1])[3 * r:3 * r + 3])
        # psum_scatter's is the all-gather of the cotangents
        np.testing.assert_array_equal(o["grad_psum_scatter"], np.concatenate(ws))
        assert o["stats"] == {"moved_bytes": 32, "staged_bytes": 0, "calls": 1}


# ---- the sharded lookups ----------------------------------------------------

V, D, B = 43, 5, 24


@pytest.fixture(scope="module", params=[2, 4], ids=["m2", "m4"])
def lookups(request):
    m = request.param
    rng = np.random.default_rng(7)
    table = rng.standard_normal((V, D)).astype(np.float32)
    ids = rng.integers(0, V, B).astype(np.int64)
    ids[:3] = [0, V - 1, ids[5]]  # the edges and a repeat
    g = rng.standard_normal((B, D)).astype(np.float32)
    out = spawn(torch_ranks.lookup_rank, m, args=(table, ids, g, (943, 1682)),
                deadline_s=DEADLINE_S)
    mesh = jax_mesh(1, m)
    jt = jax_shard_table(jnp.asarray(table), mesh)
    jids, jg = jnp.asarray(ids, jnp.int32), jnp.asarray(g)
    want = {}
    for name, fn in (("psum", jax_sharded_gather), ("scatter", jax_sharded_gather_scatter)):
        rows, vjp = jax.vjp(lambda t: fn(t, jids, mesh), jt)
        want[name] = (np.asarray(rows), np.asarray(vjp(jg)[0]))
    dense_grad = np.zeros((V, D), np.float32)
    np.add.at(dense_grad, ids, g)
    return m, out, want, table, ids, dense_grad


def test_sharded_gather_matches_jax_and_dense(lookups):
    m, out, want, table, ids, dense_grad = lookups
    for r, o in enumerate(out):
        np.testing.assert_array_equal(o["psum"]["rows"], want["psum"][0])
        np.testing.assert_array_equal(o["psum"]["rows"], table[ids])
    grad = np.concatenate([o["psum"]["grad"] for o in out])
    np.testing.assert_array_equal(grad, want["psum"][1])
    np.testing.assert_array_equal(grad[:V], dense_grad)
    assert not grad[V:].any()  # the pad rows take no gradient


def test_sharded_gather_scatter_matches_jax_and_dense(lookups):
    m, out, want, table, ids, dense_grad = lookups
    rows = np.concatenate([o["scatter"]["rows"] for o in out])
    np.testing.assert_array_equal(rows, want["scatter"][0])
    np.testing.assert_array_equal(rows, table[ids])
    grad = np.concatenate([o["scatter"]["grad"] for o in out])
    np.testing.assert_array_equal(grad, want["scatter"][1])
    np.testing.assert_array_equal(grad[:V], dense_grad)


def test_each_lookup_is_one_gather_and_one_onehot_grad(lookups):
    _, out, *_ = lookups
    for o in out:
        for name in ("psum", "scatter"):
            assert o[name]["calls"] == {"gather_rows": 1, "onehot_grad": 1,
                                        "topk_serve_matmul": 0, "topk_scores": 0}


def test_shard_table_pads_as_jax(lookups):
    m, out, *_ = lookups
    for vocab in (943, 1682):
        full = np.arange(vocab * 3, dtype=np.float32).reshape(vocab, 3)
        want = np.asarray(jax_shard_table(jnp.asarray(full), jax_mesh(1, m)))
        got = np.concatenate([o["blocks"][vocab] for o in out])
        assert got.shape[0] % m == 0 and got.shape[0] - vocab < m
        np.testing.assert_array_equal(got, want)


def test_unshard_round_trip(lookups):
    m, out, *_ = lookups
    for o in out:
        assert o["round_trip"]
        assert o["heights"] == {"user": V, "tables.item": 7}  # deep.0.w is no table
        assert o["sharded_heights"] == sorted({-(-V // m) * m, -(-7 // m) * m})


# ---- the Trainer on a mesh -----------------------------------------------------


@pytest.fixture(scope="module")
def cases():
    rng = np.random.default_rng(11)
    out = []
    for kind, jax_model in (("mf", JaxMF(U, I, **KWARGS["mf"])),
                            ("deepfm", JaxDeepFM(JaxSpec(num_users=U, num_items=I),
                                                 **KWARGS["deepfm"]))):
        splits = {}
        for name, n in SIZES.items():
            b = ((rng.integers(0, U, n).astype(np.int32), rng.integers(0, I, n).astype(np.int32))
                 if kind == "mf" else _features(rng, n))
            splits[name] = (b, (rng.random(n) < 0.4).astype(np.float32))
        params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(3)))
        out.append({"name": kind, "kind": kind, "U": U, "I": I, "kwargs": KWARGS[kind],
                    "params": params, "splits": splits, "lr": LR, "wd": WD, "jax": jax_model})
    return out


def _jax_fit(case, mesh_axes, strategy):
    mesh = jax_mesh(*mesh_axes)
    # without the per-epoch metrics, which multiply the JAX compile time on a
    # mesh tenfold; the port's are held against its own run on one rank
    tr = JaxTrainer(case["jax"], JaxConfig(learning_rate=LR, weight_decay=WD, epochs=EPOCHS,
                                           mesh=mesh, ep_strategy=strategy,
                                           track_metrics=False))
    splits, weights = {}, None
    for name, (b, y) in case["splits"].items():
        b = tuple(jnp.asarray(a) for a in b) if isinstance(b, tuple) else jnp.asarray(b)
        y = jnp.asarray(y)
        if mesh_axes[0] > 1:  # the JAX runner pads over the data axis only
            b, y, w = jax_parallel.pad_and_shard(b, y, mesh)
            weights = {**(weights or {}), name: w}
        splits[name] = (b, y)
    params = jax.tree.map(jnp.asarray, case["params"])
    return tr.fit(jax.random.PRNGKey(0), splits["train"], valid=splits["valid"],
                  test=splits["test"], weights=weights, params=params)


@pytest.fixture(scope="module", params=list(MESHES), ids=list(MESHES))
def mesh_runs(request, cases):
    axes, strategy = MESHES[request.param]
    ranks = [{k: v for k, v in c.items() if k != "jax"} for c in cases]
    got = spawn(torch_ranks.trainer_rank, axes[0] * axes[1],
                args=(axes, strategy, ranks, EPOCHS), deadline_s=DEADLINE_S)
    want = {c["name"]: _jax_fit(c, axes, strategy) for c in cases}
    return axes, strategy, got, want


@pytest.fixture(scope="module")
def one_rank(cases):
    """The port's Trainer on each case with no mesh."""
    out = {}
    for c in cases:
        model = torch_ranks.build(c["kind"], U, I, c["kwargs"], c["params"])
        splits = {}
        for name, (b, y) in c["splits"].items():
            b = tuple(torch.from_numpy(a) for a in b) if isinstance(b, tuple) else torch.from_numpy(b)
            splits[name] = (b, torch.from_numpy(y))
        out[c["name"]] = Trainer(model, TrainConfig(learning_rate=LR, weight_decay=WD,
                                                    epochs=EPOCHS), device="cpu").fit(
            splits["train"], valid=splits["valid"], test=splits["test"])
    return out


@pytest.mark.parametrize("kind", ["mf", "deepfm"])
def test_trainer_losses_match_jax(mesh_runs, kind):
    _, _, got, want = mesh_runs
    h, w = got[0][kind]["history"], want[kind].history
    assert rel_err(h["train_loss"], w["train_loss"]) <= 1e-6, (h["train_loss"],
                                                               np.asarray(w["train_loss"]))
    assert rel_err(h["_param_checksum"], w["_param_checksum"]) <= 1e-5


@pytest.mark.parametrize("kind", ["mf", "deepfm"])
def test_trainer_params_match_jax(mesh_runs, kind):
    _, _, got, want = mesh_runs
    params = got[0][kind]["params"]
    jax_params = _flat(jax.tree.map(np.asarray, want[kind].params))
    assert set(params) == set(jax_params)
    for name, w in jax_params.items():
        assert params[name].shape == w.shape, name  # whole and unpadded again
    for name, err in model_scaled_errs(params, jax_params).items():
        assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("kind", ["mf", "deepfm"])
def test_trainer_matches_one_rank(mesh_runs, one_rank, kind):
    _, _, got, _ = mesh_runs
    want = one_rank[kind]
    assert set(got[0][kind]["history"]) == set(want.history)
    for key, w in want.history.items():
        tol = 1e-5 if key == "_param_checksum" else 1e-6
        assert rel_err(got[0][kind]["history"][key], w.numpy()) <= tol, key
    for key, w in want.extras.items():
        assert rel_err(got[0][kind]["extras"][key], w) <= 1e-6, key
    for name, p in want.params.items():
        assert scaled_err(got[0][kind]["params"][name], p.numpy()) <= 1e-5, name


def test_trainer_params_replicated_and_lookups_counted(mesh_runs):
    axes, strategy, got, _ = mesh_runs
    for kind in ("mf", "deepfm"):
        ref = got[0][kind]
        for o in got[1:]:
            for name, p in ref["params"].items():
                assert np.array_equal(o[kind]["params"][name], p), (kind, name)
            np.testing.assert_array_equal(o[kind]["history"]["train_loss"],
                                          ref["history"]["train_loss"])
        # an epoch: the train forward, the valid and test forwards; then the
        # three final forwards of the AUCs; one onehot_grad a lookup a backward
        forwards = EPOCHS * 3 + 3
        for o in got:
            assert o[kind]["calls"] == {"gather_rows": forwards * LOOKUPS[kind],
                                        "onehot_grad": EPOCHS * LOOKUPS[kind],
                                        "topk_serve_matmul": 0, "topk_scores": 0}, kind
        blocks = axes[0] * (axes[1] if strategy == "scatter" else 1)
        assert got[0][kind]["rows"] == -(-SIZES["train"] // blocks)  # padded, then cut


# ---- DIEN's auxiliary loss on a split batch -------------------------------------

DIEN_KW = {"embed_size": 8, "attention_units": (16, 8, 1), "fc_units": (32, 16, 1)}
DIEN_I, DIEN_L, DIEN_B = 60, 6, 47  # an odd batch: the data axis pads one row


@pytest.mark.parametrize("mode", ["parity", "augru"])
def test_dien_auxiliary_loss_on_a_2x1_mesh_matches_jax(mode):
    """The auxiliary term is one mean over the global batch (its pad row
    included, as in the JAX trainer), not a mean a rank summed over the
    ranks: losses and params against the JAX Trainer on a (2, 1) mesh, at the
    one-device DIEN limits of ``tests/test_torch_dien.py`` (losses 1e-5
    relative, params 5e-5)."""
    flags = {"use_augru": True} if mode == "augru" else {}
    kwargs = {**DIEN_KW, **flags}
    rng = np.random.default_rng(13)
    hist = rng.integers(0, DIEN_I, (DIEN_B, DIEN_L)).astype(np.int32)
    target = rng.integers(0, DIEN_I, DIEN_B).astype(np.int32)
    neg = rng.integers(0, DIEN_I, (DIEN_B, DIEN_L)).astype(np.int32)
    y = (rng.random(DIEN_B) < 0.5).astype(np.float32)
    jax_model = JaxDIEN(DIEN_I, **kwargs)
    params = jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(1)))
    splits = {"train": ((hist, target, neg), y), "valid": ((hist, target), y),
              "test": ((hist, target), y)}
    case = {"name": "dien", "kind": "dien", "U": 0, "I": DIEN_I, "kwargs": kwargs,
            "params": params, "splits": splits, "lr": LR, "wd": WD, "aux_weight": 0.5}
    got = spawn(torch_ranks.trainer_rank, 2, args=((2, 1), "psum", [case], EPOCHS),
                deadline_s=DEADLINE_S)
    mesh = jax_mesh(2, 1)
    tr = JaxTrainer(jax_model, JaxConfig(learning_rate=LR, weight_decay=WD, epochs=EPOCHS,
                                         mesh=mesh, track_metrics=False),
                    aux_loss_fn="model", aux_weight=0.5)
    jsplits, weights = {}, {}
    for name, (b, lab) in splits.items():
        jb, jy, weights[name] = jax_parallel.pad_and_shard(
            tuple(jnp.asarray(a) for a in b), jnp.asarray(lab), mesh)
        jsplits[name] = (jb, jy)
    want = tr.fit(jax.random.PRNGKey(0), jsplits["train"], valid=jsplits["valid"],
                  test=jsplits["test"], weights=weights, params=jax.tree.map(jnp.asarray, params))
    for o in got:
        h = o["dien"]["history"]
        assert rel_err(h["train_loss"], want.history["train_loss"]) <= 1e-5, (
            h["train_loss"], np.asarray(want.history["train_loss"]))
    jax_params = _flat(jax.tree.map(np.asarray, want.params))
    assert set(got[0]["dien"]["params"]) == set(jax_params)
    for name, w in jax_params.items():
        np.testing.assert_allclose(got[0]["dien"]["params"][name], w, rtol=0, atol=5e-5,
                                   err_msg=name)
    for name, p in got[0]["dien"]["params"].items():  # replicated on both ranks
        assert np.array_equal(got[1]["dien"]["params"][name], p), name


# ---- run_experiment on a (2, 2) mesh ------------------------------------------

EXP_U, EXP_I, EXP_R = 40, 300, 2400  # the feature family needs >= 300 items
EXP_OVER = {"mf": {"epochs": EPOCHS, "track_metrics": False,
                   "model_kwargs": {"embedding_dim": 8}},
            "deepfm": {"epochs": EPOCHS, "track_metrics": False,
                       "model_kwargs": KWARGS["deepfm"]}}


@pytest.fixture(scope="module")
def experiment_runs(tmp_path_factory):
    data_dir = write_ml100k_format(str(tmp_path_factory.mktemp("mesh")), seed=5,
                                   num_users=EXP_U, num_items=EXP_I, num_ratings=EXP_R)
    jx = JaxMovieLens(data_dir, seed=0, use_native=False)
    orig_make_mesh, orig_sampler = jax_parallel.make_mesh, jax_experiments.NegativeSampler
    cases, want = [], {}
    draws = []

    class Recording(JaxSampler):  # the JAX sampler, its draws kept for the port's ranks
        def sample(self, n):
            out = super().sample(n)
            draws.append({k: np.array(v) for k, v in out.items()})
            return out

    jax_parallel.make_mesh = lambda data=None, model=1, devices=None: orig_make_mesh(
        data, model, jax.devices()[:data * model])
    jax_experiments.NegativeSampler = Recording
    try:
        for name in ("mf", "deepfm"):
            draws.clear()
            cfg = JAX_PRESETS[name].replace(mesh_shape=(2, 2), **EXP_OVER[name])
            model = jax_experiments.build_model(cfg, jx)
            params = model.init(jax.random.PRNGKey(cfg.seed))
            want[name] = jax_experiments.run_experiment(cfg, data=jx)
            cases.append({"name": name, "preset": name,
                          "over": {"mesh_shape": (2, 2), **EXP_OVER[name]},
                          "draws": list(draws), "params": jax.tree.map(np.asarray, params)})
    finally:
        jax_parallel.make_mesh, jax_experiments.NegativeSampler = orig_make_mesh, orig_sampler
    got = spawn(torch_ranks.experiment_rank, 4, args=(data_dir, cases), deadline_s=DEADLINE_S)
    return got, want


@pytest.mark.parametrize("name", ["mf", "deepfm"])
def test_run_experiment_on_a_2x2_mesh_matches_jax(experiment_runs, name):
    got, want = experiment_runs
    g, w = got[0][name], want[name]
    assert rel_err(g["history"]["train_loss"], w.history["train_loss"]) <= 1e-6
    jax_params = _flat(jax.tree.map(np.asarray, w.params))
    for pname, err in model_scaled_errs(g["params"], jax_params).items():
        assert err <= 1e-5, (pname, err)
    for split in w.ranking:
        for metric, value in w.ranking[split].items():
            np.testing.assert_allclose(g["ranking"][split][metric], value, rtol=1e-6,
                                       err_msg=f"{split} {metric}")
    for o in got[1:]:  # every rank returns the same result
        np.testing.assert_array_equal(o[name]["history"]["train_loss"], g["history"]["train_loss"])
        assert o[name]["ranking"] == g["ranking"]


# ---- sparse and stream modes on a mesh ------------------------------------------


@pytest.fixture(scope="module")
def mode_runs(cases):
    mf, fm = cases
    ranks = [{k: v for k, v in c.items() if k != "jax"} for c in cases]
    got = spawn(torch_ranks.modes_rank, 2, args=(ranks,), deadline_s=DEADLINE_S)
    want = torch_ranks.modes_rank(0, 1, ranks)  # the same calls on one rank, no mesh
    return got, want


@pytest.mark.parametrize("run", ["mf_lazy_adam", "mf_rowwise_adagrad", "deepfm_lazy_adam",
                                 "mf_lazy_adam_sharded", "mf_stream"])
def test_modes_on_a_mesh_match_one_rank(mode_runs, run):
    got, want = mode_runs
    w = want[run]
    for rank, o in enumerate(got):
        g = o[run]
        assert rel_err(g["train_loss"], w["train_loss"]) <= 1e-6
        for name, p in w["params"].items():
            if run.endswith("_sharded"):  # each rank holds its block, padded
                p = np.concatenate([p, np.zeros((-len(p) % 2,) + p.shape[1:], p.dtype)])
                p = np.split(p, 2)[rank]
            assert g["params"][name].shape == p.shape, name
            assert scaled_err(g["params"][name], p) <= 1e-6, (run, name)
    if run.endswith("_sharded"):
        assert got[0][run]["ep_heights"] == {"user": U, "item": I}
