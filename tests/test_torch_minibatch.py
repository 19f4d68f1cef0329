"""The port's ``train/minibatch.py::fit_minibatch`` against the JAX package's on
the same weights (carried across with ``params_from_jax``) and the same NumPy
batches, each epoch's order replayed from the JAX run: ``epoch_order`` is
replaced by the JAX function's own draws (``split(rng)`` -> ``split(shuffle,
epochs)`` -> ``permutation(erng, n)[: nb * bs]``), since ``jax.random`` cannot
be replayed in torch.

Tolerances, float32: losses rtol 1e-5, params atol 1e-5 (sums in another
order: XLA's scatter-add and optax's Adam against ``onehot_grad`` and
``torch.optim.Adam``), on MF, a narrow DeepFM and a narrow DIN. MF under
bfloat16 compute: the JAX default route sums the gather's gradient in bf16,
the port in float32 before its bf16 cast, and Adam's normalised steps carry
the difference: losses rtol 1e-4, params atol 2e-3 after 3 epochs of 7 steps
at lr 0.01 (measured: 2.3e-5 and 3.8e-4), the full-batch Trainer's bf16 test's
limits tightened to this run's measurement with headroom.

Also: the order is a seeded draw that a CPU generator continues across calls
(2 + 2 epochs with one generator equal 4 epochs), ``params``/``opt_state``
resume the JAX run's state, a batch larger than the data raises, and the
masked-matrix family is refused by ``run_experiment``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.features import FeatureSpec as JaxSpec
from deeplearningrecommendationsystem_tpu.models import DIN as JaxDIN
from deeplearningrecommendationsystem_tpu.models import DeepFM as JaxDeepFM
from deeplearningrecommendationsystem_tpu.models import MatrixFactorization as JaxMF
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu.train import fit_minibatch as jax_fit_minibatch
from deeplearningrecommendationsystem_tpu_torch import experiments
from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models import DIN, DeepFM, MatrixFactorization
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer, fit_minibatch
from deeplearningrecommendationsystem_tpu_torch.train import minibatch
from jax_order import jax_order
from deeplearningrecommendationsystem_tpu_torch.weights import opt_state_from_jax, params_from_jax

U, I, D, N, BS, EPOCHS, LR, WD = 30, 40, 8, 450, 64, 3, 0.01, 1e-5
KEY = 4  # the JAX run's rng seed


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test (many small ops; see tests/test_torch_cli_run.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _flat(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        nested = isinstance(v, (dict, list, tuple))
        out.update(_flat(v, f"{prefix}{k}.") if nested else {f"{prefix}{k}": np.asarray(v)})
    return out


def _pair_batch(rng):
    users = rng.integers(0, U, N).astype(np.int32)
    items = rng.integers(0, I, N).astype(np.int32)
    return (users, items), (rng.random(N) < 0.4).astype(np.float32)


def _features(rng, n=N):
    x = np.zeros((n, 45), np.float32)
    x[:, 0] = rng.integers(0, U, n)
    x[:, 1] = rng.integers(0, I, n)
    x[:, 2] = rng.random(n)
    x[np.arange(n), 3 + rng.integers(0, 2, n)] = 1
    x[np.arange(n), 5 + rng.integers(0, 21, n)] = 1
    x[:, 26:] = rng.random((n, 19)) < 0.2
    return x, (rng.random(n) < 0.4).astype(np.float32)


def _din_batch(rng):
    hist = rng.integers(0, I, (N, 6))
    return (hist, rng.integers(0, I, N)), (rng.random(N) < 0.5).astype(np.float32)


# case -> (JAX model, port model factory, batch)
SPEC, JAX_SPEC = FeatureSpec(num_users=U, num_items=I), JaxSpec(num_users=U, num_items=I)
DIN_KW = {"embed_size": 8, "attention_units": (16, 8, 1), "fc_units": (16, 8, 1)}
CASES = {
    "mf": (lambda: JaxMF(U, I, D), lambda: MatrixFactorization(U, I, D, device="cpu"),
           _pair_batch),
    "deepfm": (lambda: JaxDeepFM(JAX_SPEC, (16, 8, 1), 8, robust_init=True),
               lambda: DeepFM(SPEC, (16, 8, 1), 8, robust_init=True, device="cpu"), _features),
    "din": (lambda: JaxDIN(I, **DIN_KW), lambda: DIN(I, **DIN_KW, device="cpu"), _din_batch),
}


def _tree(batch, fn):
    return tuple(fn(a) for a in batch) if isinstance(batch, tuple) else fn(batch)


def _runs(monkeypatch, case, compute_dtype=None, epochs=EPOCHS):
    jax_model, port_model, make = CASES[case]
    batch, y = make(np.random.default_rng(1))
    key = jax.random.PRNGKey(KEY)
    params = jax.tree.map(np.asarray, jax_model().init(jax.random.PRNGKey(3)))
    cfg = dict(learning_rate=LR, weight_decay=WD, epochs=epochs, compute_dtype=compute_dtype)
    want = jax_fit_minibatch(JaxTrainer(jax_model(), JaxConfig(**cfg)), key,
                             (_tree(batch, jnp.asarray), jnp.asarray(y)), BS,
                             params=jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr(minibatch, "epoch_order", jax_order(key))
    model = params_from_jax(port_model(), params)
    trainer = Trainer(model, TrainConfig(**cfg), device="cpu")
    got = fit_minibatch(trainer, 0, (_tree(batch, torch.from_numpy), torch.from_numpy(y)), BS)
    return got, want, (batch, y, params, key, cfg)


@pytest.mark.parametrize("case", list(CASES))
def test_fit_minibatch_matches_jax(monkeypatch, case):
    got, want, _ = _runs(monkeypatch, case)
    assert set(got.history) == set(want.history) == {"train_loss"}
    assert got.history["train_loss"].shape == (EPOCHS,)
    np.testing.assert_allclose(got.history["train_loss"].numpy(),
                               np.asarray(want.history["train_loss"]), rtol=1e-5)
    want_params = _flat(want.params)
    assert set(got.params) == set(want_params)
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=1e-5, err_msg=k)


def test_fit_minibatch_bfloat16_matches_jax(monkeypatch):
    got, want, _ = _runs(monkeypatch, "mf", compute_dtype="bfloat16")
    np.testing.assert_allclose(got.history["train_loss"].numpy(),
                               np.asarray(want.history["train_loss"]), rtol=1e-4)
    for k, v in got.params.items():
        assert v.dtype == torch.float32  # f32 master weights
        np.testing.assert_allclose(v.numpy(), np.asarray(want.params[k]), atol=2e-3, err_msg=k)


def test_resume_from_the_jax_state(monkeypatch):
    """Two more epochs from the JAX run's params and Adam state, in both packages."""
    _, want, (batch, y, _, key, cfg) = _runs(monkeypatch, "mf")
    cfg = dict(cfg, epochs=2)
    key2 = jax.random.PRNGKey(KEY + 1)
    again = jax_fit_minibatch(JaxTrainer(JaxMF(U, I, D), JaxConfig(**cfg)), key2,
                              (_tree(batch, jnp.asarray), jnp.asarray(y)), BS,
                              params=want.params, opt_state=want.opt_state)
    monkeypatch.setattr(minibatch, "epoch_order", jax_order(key2))
    model = MatrixFactorization(U, I, D, device="cpu")
    trainer = Trainer(model, TrainConfig(**cfg), device="cpu")
    resumed = fit_minibatch(trainer, 0, (_tree(batch, torch.from_numpy), torch.from_numpy(y)), BS,
                            params={k: torch.from_numpy(np.array(v))
                                    for k, v in want.params.items()},
                            opt_state=opt_state_from_jax(model, want.opt_state))
    np.testing.assert_allclose(resumed.history["train_loss"].numpy(),
                               np.asarray(again.history["train_loss"]), rtol=1e-5)
    for k, v in resumed.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(again.params[k]), atol=1e-5, err_msg=k)
    assert resumed.opt_state["user"]["step"] == 2 * (N // BS) + EPOCHS * (N // BS)


def test_order_is_seeded_and_continues_across_calls():
    (batch, y) = _pair_batch(np.random.default_rng(2))
    a = minibatch.epoch_order(7, N, 3, BS)
    assert a.shape == (3, N // BS, BS) and a.dtype == torch.int64
    torch.testing.assert_close(a, minibatch.epoch_order(torch.Generator().manual_seed(7), N, 3, BS))
    for row in a.reshape(3, -1):  # each epoch draws distinct rows
        assert len(set(row.tolist())) == (N // BS) * BS

    def run(splits, gen):
        model = MatrixFactorization(U, I, D, generator=torch.Generator().manual_seed(0),
                                    device="cpu")
        out = []
        for epochs in splits:
            trainer = Trainer(model, TrainConfig(learning_rate=LR, epochs=epochs), device="cpu")
            res = fit_minibatch(trainer, gen, ((torch.from_numpy(batch[0]),
                                                torch.from_numpy(batch[1])), torch.from_numpy(y)),
                                BS, opt_state=res.opt_state if out else None)
            out.append(res)
        return out

    whole = run([4], torch.Generator().manual_seed(9))[-1]
    halves = run([2, 2], torch.Generator().manual_seed(9))
    torch.testing.assert_close(torch.cat([h.history["train_loss"] for h in halves]),
                               whole.history["train_loss"], rtol=0, atol=0)
    for k in whole.params:
        torch.testing.assert_close(halves[-1].params[k], whole.params[k], rtol=0, atol=0)


def test_batch_larger_than_the_data_raises():
    trainer = Trainer(MatrixFactorization(U, I, D, device="cpu"), TrainConfig(epochs=1),
                      device="cpu")
    with pytest.raises(ValueError, match="larger than the dataset"):
        fit_minibatch(trainer, 0, ((torch.zeros(5, dtype=torch.int64),) * 2, torch.zeros(5)), 8)


@pytest.mark.parametrize("mode", ["minibatch", "stream"])
def test_matrix_family_is_refused(tmp_path, mode):
    data = MovieLens100K(write_ml100k_format(str(tmp_path), seed=5, num_users=30,
                                             num_items=60, num_ratings=900), seed=0)
    with pytest.raises(ValueError, match="masked-matrix family N/A"):
        experiments.run_experiment(PRESETS["autorec"].replace(epochs=1, train_mode=mode),
                                   data=data, device="cpu")


def test_order_is_randperm_s_and_leaves_the_thread_count():
    """``epoch_order`` gives each epoch ``torch.randperm``'s permutation from
    the rng's generator, and leaves the process's thread count as it was."""
    before = torch.get_num_threads()
    got = minibatch.epoch_order(11, 1000, 2, 100)
    assert torch.get_num_threads() == before
    gen = torch.Generator().manual_seed(11)
    want = torch.stack([torch.randperm(1000, generator=gen).view(10, 100) for _ in range(2)])
    assert torch.equal(got, want)
