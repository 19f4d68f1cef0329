"""The port's ``data/stream.py`` and ``train/minibatch.py::fit_stream`` against
the JAX package's.

* ``epoch_batches``, ``prefetch_to_device`` and ``StreamingLoader`` give the
  JAX package's indices and batches exactly (the host order is NumPy's in
  both), on the CPU as tensors;
* ``fit_stream`` on MF and a narrow DeepFM from the same weights: losses rtol
  1e-5, params atol 1e-5 (as ``tests/test_torch_minibatch.py``);
* a ``sharding`` keeps this rank's block of each batch, and the loader
  defaults to CUDA, raising where there is none.

The pinned, side-stream copy is the CUDA route; ``chip_smoke.py``'s ``stream``
phase and a ``cuda``-marked test in ``tests/test_torch_isolation.py`` (a file
that imports no JAX) drive it on the card.
"""

import jax
import jax.numpy as jnp
import types

import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.data import stream as jax_stream
from deeplearningrecommendationsystem_tpu.features import FeatureSpec as JaxSpec
from deeplearningrecommendationsystem_tpu.models import DeepFM as JaxDeepFM
from deeplearningrecommendationsystem_tpu.models import MatrixFactorization as JaxMF
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu.train import fit_stream as jax_fit_stream
from deeplearningrecommendationsystem_tpu_torch.data import stream
from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models import DeepFM, MatrixFactorization
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer, fit_stream
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

U, I, N, BS, EPOCHS = 30, 40, 450, 64, 3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test (many small ops; see tests/test_torch_cli_run.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("drop_last", [True, False])
def test_epoch_batches_equal_jax(drop_last):
    got = list(stream.epoch_batches(np.random.default_rng(3), 103, 16, drop_last))
    want = list(jax_stream.epoch_batches(np.random.default_rng(3), 103, 16, drop_last))
    assert len(got) == len(want) == (6 if drop_last else 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_yields_every_batch_in_order(size):
    batches = [(np.arange(4) + i, {"y": np.full(2, i, np.float32)}) for i in range(4)]
    got = list(stream.prefetch_to_device(iter(batches), size, device="cpu"))
    want = list(jax_stream.prefetch_to_device(iter(batches), size))
    assert len(got) == len(want) == 4
    for (g, gy), (w, wy) in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(gy["y"].numpy(), np.asarray(wy["y"]))


def test_streaming_loader_equals_jax():
    rng = np.random.default_rng(0)
    arrays = ((rng.integers(0, U, N), rng.integers(0, I, N)), rng.random(N).astype(np.float32))
    got = stream.StreamingLoader(arrays, BS, seed=5, device="cpu")
    want = jax_stream.StreamingLoader(arrays, BS, seed=5)
    assert len(got) == len(want) == N // BS
    for _ in range(2):  # two epochs: the generator carries on
        pairs = list(zip(got.epoch(), want.epoch()))
        assert len(pairs) == N // BS
        for ((gu, gi), gy), ((wu, wi), wy) in pairs:
            np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
            np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
            np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))


def test_sharding_raises_and_cuda_is_the_default(monkeypatch):
    """A ``sharding`` keeps this rank's block of every batch's rows (a
    ``parallel/mesh.py::RowSharding``; here a stand-in holding the second of
    two blocks), and raises where the batch does not split into its blocks."""
    second_half = types.SimpleNamespace(parts=2, take=lambda a: a[len(a) // 2:])
    with pytest.raises(ValueError, match="does not split into 2 blocks"):
        stream.StreamingLoader(np.zeros(8), 3, sharding=second_half, device="cpu")
    rows = np.arange(8)
    got = list(stream.StreamingLoader(rows, 4, seed=1, sharding=second_half, device="cpu").epoch())
    want = list(stream.StreamingLoader(rows, 4, seed=1, device="cpu").epoch())
    assert [g.tolist() for g in got] == [w[2:].tolist() for w in want]
    (block,) = stream.prefetch_to_device(iter([np.arange(6)]), sharding=second_half, device="cpu")
    assert block.tolist() == [3, 4, 5]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        stream.StreamingLoader(np.zeros(4), 2)


def _pair(rng):
    users = rng.integers(0, U, N).astype(np.int32)
    items = rng.integers(0, I, N).astype(np.int32)
    return (users, items), (rng.random(N) < 0.4).astype(np.float32)


def _features(rng):
    x = np.zeros((N, 45), np.float32)
    x[:, 0] = rng.integers(0, U, N)
    x[:, 1] = rng.integers(0, I, N)
    x[:, 2] = rng.random(N)
    x[np.arange(N), 3 + rng.integers(0, 2, N)] = 1
    x[np.arange(N), 5 + rng.integers(0, 21, N)] = 1
    x[:, 26:] = rng.random((N, 19)) < 0.2
    return x, (rng.random(N) < 0.4).astype(np.float32)


SPEC, JAX_SPEC = FeatureSpec(num_users=U, num_items=I), JaxSpec(num_users=U, num_items=I)
MODELS = {
    "mf": (lambda: JaxMF(U, I, 8), lambda: MatrixFactorization(U, I, 8, device="cpu"), _pair),
    "deepfm": (lambda: JaxDeepFM(JAX_SPEC, (16, 8, 1), 8, robust_init=True),
               lambda: DeepFM(SPEC, (16, 8, 1), 8, robust_init=True, device="cpu"), _features),
}


def _flat(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        nested = isinstance(v, (dict, list, tuple))
        out.update(_flat(v, f"{prefix}{k}.") if nested else {f"{prefix}{k}": np.asarray(v)})
    return out


@pytest.mark.parametrize("model", list(MODELS))
def test_fit_stream_matches_jax(model):
    jax_model, port_model, make = MODELS[model]
    batch, y = make(np.random.default_rng(7))
    params = jax.tree.map(np.asarray, jax_model().init(jax.random.PRNGKey(3)))
    cfg = dict(learning_rate=0.01, weight_decay=1e-5, epochs=EPOCHS)
    want = jax_fit_stream(JaxTrainer(jax_model(), JaxConfig(**cfg)), jax.random.PRNGKey(0),
                          (batch, y), BS, params=jax.tree.map(jnp.asarray, params), seed=11)
    trainer = Trainer(params_from_jax(port_model(), params), TrainConfig(**cfg), device="cpu")
    got = fit_stream(trainer, 0, (batch, y), BS, seed=11)
    assert set(got.history) == {"train_loss"} and got.history["train_loss"].shape == (EPOCHS,)
    np.testing.assert_allclose(got.history["train_loss"].numpy(),
                               np.asarray(want.history["train_loss"]), rtol=1e-5)
    want_params = _flat(want.params)
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=1e-5, err_msg=k)
