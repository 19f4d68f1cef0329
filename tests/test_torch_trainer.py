"""The port's ``Trainer`` against the JAX package's on the same MF weights
(carried across with ``params_from_jax``) and the same train, valid and test
batches, made with NumPy from a seed.

Every ``history`` key (the same key set), ``extras``, the final params and
``_param_checksum`` are compared. Tolerances, float32: losses and AUCs rtol
1e-5 and params atol 1e-5 (sums in another order: XLA's scatter-add and
optax's Adam against ``onehot_grad`` and ``torch.optim.Adam``); the
thresholded metrics (accuracy, precision, recall, F1, the quirk AUC) exactly:
on these inputs the closest probability lies 5e-6 from the 0.5 threshold,
hundreds of times the float32 differences between the packages.
bfloat16 compute: the JAX default route sums the gather's gradient in bf16,
the port in f32 before its bf16 cast, so the two differ by bf16 roundings
that Adam's normalised steps carry: losses rtol 1e-4 and params atol 5e-3
after 4 epochs at lr 0.01 (measured: 1.8e-5 and 1.1e-3), and the checksum, a
sum of 1680 such values near -3.2, atol 1e-2 (measured: 1.1e-3); the rank
AUCs atol 1e-3, about ten of the train split's ~9.6k positive-negative pairs
changing order (measured: 1.0e-4, one pair).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.models import MatrixFactorization as JaxMF
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.weights import opt_state_from_jax, params_from_jax

U, I, D, EPOCHS, LR, WD = 30, 40, 8, 4, 0.01, 1e-5
SIZES = {"train": 200, "valid": 80, "test": 80}
THRESHOLDED = ("accuracy", "precision", "recall", "f1", "auc")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    params = {k: np.array(v) for k, v in JaxMF(U, I, D).init(jax.random.PRNGKey(3)).items()}
    splits = {}
    for name, n in SIZES.items():
        users = rng.integers(0, U, n).astype(np.int32)
        items = rng.integers(0, I, n).astype(np.int32)
        splits[name] = ((users, items), (rng.random(n) < 0.4).astype(np.float32))
    masks = {name: (rng.random(n) < 0.7).astype(np.float32) for name, n in SIZES.items()}
    return params, splits, masks


def _jax_split(split):
    (u, i), y = split
    return (jnp.asarray(u), jnp.asarray(i)), jnp.asarray(y)


def _port_split(split):
    (u, i), y = split
    return (torch.from_numpy(u), torch.from_numpy(i)), torch.from_numpy(y)


def _run_jax(params, splits, weights=None, compute_dtype=None, opt_state=None, epochs=EPOCHS):
    tr = JaxTrainer(JaxMF(U, I, D), JaxConfig(learning_rate=LR, weight_decay=WD, epochs=epochs,
                                              track_metrics=True, compute_dtype=compute_dtype))
    return tr.fit(jax.random.PRNGKey(0), _jax_split(splits["train"]),
                  valid=_jax_split(splits["valid"]), test=_jax_split(splits["test"]),
                  weights=None if weights is None else {k: jnp.asarray(v) for k, v in weights.items()},
                  params={k: jnp.asarray(v) for k, v in params.items()}, opt_state=opt_state)


def _run_port(params, splits, weights=None, compute_dtype=None, opt_state=None, epochs=EPOCHS):
    model = params_from_jax(MatrixFactorization(U, I, D, device="cpu"), params)
    tr = Trainer(model, TrainConfig(learning_rate=LR, weight_decay=WD, epochs=epochs,
                                    track_metrics=True, compute_dtype=compute_dtype), device="cpu")
    return tr.fit(_port_split(splits["train"]), valid=_port_split(splits["valid"]),
                  test=_port_split(splits["test"]),
                  weights=None if weights is None else {k: torch.from_numpy(v)
                                                        for k, v in weights.items()},
                  opt_state=opt_state)


def _assert_match(got, want, rtol=1e-5, atol=1e-5, exact_thresholded=True, checksum_atol=0.0,
                  auc_atol=0.0):
    assert set(got.history) == set(want.history)
    assert len(got.history) == 1 + 3 * 6 - 1 + 1  # train_* (6), valid_*, test_* and the checksum
    for key, w in want.history.items():
        g = got.history[key].numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, key
        if key == "_param_checksum":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=checksum_atol, err_msg=key)
        elif key.split("_", 1)[1] in THRESHOLDED and exact_thresholded:
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif key.split("_", 1)[1] not in THRESHOLDED:
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=key)
    assert got.history["_param_checksum"].shape == (1,)
    assert set(got.extras) == set(want.extras) == {"train_auc_raw", "valid_auc_raw", "test_auc_raw"}
    for key in want.extras:
        np.testing.assert_allclose(got.extras[key], want.extras[key], rtol=rtol, atol=auc_atol,
                                   err_msg=key)
    for key in ("user", "item"):
        np.testing.assert_allclose(got.params[key].numpy(), np.asarray(want.params[key]),
                                   atol=atol, err_msg=key)
    assert got.last().keys() == {k for k in want.last()}


def test_trainer_matches_jax(data):
    params, splits, _ = data
    _assert_match(_run_port(params, splits), _run_jax(params, splits))


def test_trainer_weighted_mask_matches_jax(data):
    params, splits, masks = data
    _assert_match(_run_port(params, splits, weights=masks), _run_jax(params, splits, weights=masks))


def test_trainer_bfloat16_matches_jax(data):
    params, splits, _ = data
    got = _run_port(params, splits, compute_dtype="bfloat16")
    want = _run_jax(params, splits, compute_dtype="bfloat16")
    assert got.params["user"].dtype == torch.float32  # f32 master weights
    _assert_match(got, want, rtol=1e-4, atol=5e-3, exact_thresholded=False, checksum_atol=1e-2,
                  auc_atol=1e-3)


def test_trainer_resumes_from_jax_state(data):
    """Both packages train 2 epochs, then the port resumes from the JAX
    params and optax Adam state (``opt_state_from_jax``) for 2 more, against
    the JAX trainer's own resume."""
    params, splits, _ = data
    first = _run_jax(params, splits, epochs=2)
    want = _run_jax({k: np.asarray(v) for k, v in first.params.items()}, splits,
                    opt_state=first.opt_state, epochs=2)
    model = MatrixFactorization(U, I, D, device="cpu")
    state = opt_state_from_jax(model, first.opt_state)
    assert set(state) == {"user", "item"} and float(state["user"]["step"]) == 2.0
    got = _run_port({k: np.asarray(v) for k, v in first.params.items()}, splits,
                    opt_state=state, epochs=2)
    _assert_match(got, want)
    # the checksum sums params and both moments: the JAX value, within float32 sums
    np.testing.assert_allclose(got.history["_param_checksum"].numpy(),
                               np.asarray(want.history["_param_checksum"]), rtol=1e-5)


def test_checksum_leaves_out_the_step_count(data):
    params, splits, _ = data
    got = _run_port(params, splits)
    expected = sum(float(v.sum()) for v in got.params.values())
    expected += sum(float(st[k].sum()) for st in got.opt_state.values()
                    for k in ("exp_avg", "exp_avg_sq"))
    np.testing.assert_allclose(float(got.history["_param_checksum"][0]), expected, rtol=1e-6)
    np.testing.assert_allclose(got.history["_param_checksum"].numpy(),
                               np.asarray(_run_jax(params, splits).history["_param_checksum"]),
                               rtol=1e-5)


def test_trainer_rejects_a_mesh():
    """A mesh is a ``parallel/mesh.py::make_mesh`` DeviceMesh (the mesh runs
    are ``tests/test_torch_parallel.py``'s), and the lookup strategy one of
    the two."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(MatrixFactorization(U, I, D, device="cpu"), TrainConfig(mesh=object()),
                device="cpu")
    with pytest.raises(ValueError, match="ep_strategy"):
        Trainer(MatrixFactorization(U, I, D, device="cpu"), TrainConfig(ep_strategy="gather"),
                device="cpu")


def test_config_takes_the_jax_fields():
    """Every field of the JAX ``TrainConfig`` builds the port's, with the JAX
    defaults."""
    import dataclasses

    shared = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    cfg = TrainConfig(**shared)
    assert {f.name for f in dataclasses.fields(TrainConfig)} == set(shared)
    assert (cfg.ep_strategy, cfg.unshard_params) == ("psum", True)
    for name in ("matmul_gather_bwd", "pallas_gather", "onehot_gather"):
        assert getattr(cfg, name) is False
        assert TrainConfig(**{name: True}).mesh is None


@pytest.mark.parametrize("flag", ["matmul_gather_bwd", "pallas_gather", "onehot_gather"])
def test_gather_route_flags_leave_the_losses_unchanged(data, flag):
    params, splits, _ = data
    plain = _run_port(params, splits, epochs=2)
    model = params_from_jax(MatrixFactorization(U, I, D, device="cpu"), params)
    flagged = Trainer(model, TrainConfig(learning_rate=LR, weight_decay=WD, epochs=2,
                                         track_metrics=True, **{flag: True}), device="cpu").fit(
        _port_split(splits["train"]), valid=_port_split(splits["valid"]),
        test=_port_split(splits["test"]))
    for key in ("train_loss", "valid_loss", "test_loss", "_param_checksum"):
        assert torch.equal(flagged.history[key], plain.history[key]), key
