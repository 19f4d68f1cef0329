"""The port's fused MF trainer against the JAX package's Pallas kernel
(``ops/pallas/mf_epoch.py::mf_fullbatch_train``, interpret mode on the CPU,
block_rows=64) on the same NumPy inputs, U, I, D, B = 50, 81, 16, 300 over 6
epochs (and at D 192 and 256, which the CUDA kernel takes with 8 columns a
lane, on 120 rows over 3 epochs), and against the port's own ``Trainer``.

Tolerances: in float32, losses rtol 2e-5 and tables atol 2e-5, those of
``tests/test_kernels.py::test_mf_fused_kernel_matches_trainer`` (the sums run
in another order). In bfloat16 both round the same values to bf16, but a
gradient row can round the other way where its f32 product differs in the
last bit, and Adam's first steps move each weight by about lr whatever the
gradient's size: losses rtol 1e-3, tables atol 2e-3 (a fifth of one step of
lr = 0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.models import MatrixFactorization as JaxMF
from deeplearningrecommendationsystem_tpu.ops.pallas.mf_epoch import (
    mf_fullbatch_train as jax_mf_fullbatch_train,
)
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization
from deeplearningrecommendationsystem_tpu_torch.ops import mf_epoch as port
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

U, I, D, B, EPOCHS, LR, WD = 50, 81, 16, 300, 6, 0.01, 1e-5
TOL = {"float32": {"rtol": 2e-5, "atol": 2e-5}, "bfloat16": {"rtol": 1e-3, "atol": 2e-3}}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    params = {k: np.array(v) for k, v in JaxMF(U, I, D).init(jax.random.PRNGKey(2)).items()}
    uid = rng.integers(0, U, B).astype(np.int32)
    iid = rng.integers(0, I, B).astype(np.int32)
    y = (rng.random(B) < 0.5).astype(np.float32)
    return params, uid, iid, y


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas(inputs, compute_dtype):
    params, uid, iid, y = inputs
    want_pu, want_pi, want_losses = jax_mf_fullbatch_train(
        jnp.asarray(uid), jnp.asarray(iid), jnp.asarray(y), jnp.asarray(params["user"]),
        jnp.asarray(params["item"]), EPOCHS, LR, WD, compute_dtype, block_rows=64,
        interpret=True)
    args = [torch.from_numpy(a) for a in (uid, iid, y, params["user"], params["item"])]
    pu, pi, losses = port.mf_fullbatch_train_plain(*args, EPOCHS, LR, WD, compute_dtype)
    tol = TOL[compute_dtype]
    assert losses.shape == (EPOCHS,) and pu.dtype == pi.dtype == torch.float32
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=tol["rtol"])
    np.testing.assert_allclose(pu.numpy(), np.asarray(want_pu), atol=tol["atol"])
    np.testing.assert_allclose(pi.numpy(), np.asarray(want_pi), atol=tol["atol"])
    # the public wrapper takes the plain version on CPU tensors
    got = port.mf_fullbatch_train(*args, EPOCHS, LR, WD, compute_dtype)
    for a, b in zip(got, (pu, pi, losses)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_out_of_range_ids_match_nothing(inputs):
    """Ids outside [0, V) get a zero embedding and no gradient, as the Pallas
    one-hot mask matches none. (The Pallas kernel pads V to a multiple of 8
    and an id in that padding does match a padded row, which Adam then moves:
    the ids here lie beyond it.)"""
    params, uid, iid, y = inputs
    uid, iid = uid.copy(), iid.copy()
    uid[:7] = [-1, U + 8, U + 30, -U, 0, 1, 2]
    iid[3:5] = [I + 7, -2]
    want = jax_mf_fullbatch_train(
        jnp.asarray(uid), jnp.asarray(iid), jnp.asarray(y), jnp.asarray(params["user"]),
        jnp.asarray(params["item"]), 3, LR, WD, "float32", block_rows=64, interpret=True)
    got = port.mf_fullbatch_train_plain(
        *[torch.from_numpy(a) for a in (uid, iid, y, params["user"], params["item"])],
        3, LR, WD, "float32")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)


def test_fast_fit_matches_trainer(inputs):
    """The port's fast_fit (fused kernel path) against the port's Trainer with
    the same Adam and weight decay: loss curve and final tables, f32."""
    params, uid, iid, y = inputs
    model = params_from_jax(MatrixFactorization(U, I, D, device="cpu"), params)
    batch = (torch.from_numpy(uid), torch.from_numpy(iid))
    yt = torch.from_numpy(y)
    got, losses = model.fast_fit(dict(model.named_parameters()), batch, yt, EPOCHS, LR,
                                 weight_decay=WD, compute_dtype="float32")
    # fast_fit leaves the module's own tables as they are
    np.testing.assert_array_equal(model.user.detach().numpy(), params["user"])
    tr = Trainer(model, TrainConfig(learning_rate=LR, weight_decay=WD, epochs=EPOCHS,
                                    track_metrics=False), device="cpu")
    want = tr.fit((batch, yt))
    np.testing.assert_allclose(losses.numpy(), want.history["train_loss"].numpy(), rtol=2e-5)
    for k in ("user", "item"):
        np.testing.assert_allclose(got[k].numpy(), want.params[k].numpy(), atol=2e-5)


@pytest.mark.parametrize("width", [192, 256])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_at_wide_factors(compute_dtype, width):
    """D past 128, which ``mf_epoch_kernel`` takes since it templated its
    columns a lane (8 at D 192 and 256): the plain version against the Pallas
    kernel at a small row count, 3 epochs, the tolerances above."""
    rng = np.random.default_rng(width)
    params = {k: np.array(v) for k, v in JaxMF(U, I, width).init(jax.random.PRNGKey(3)).items()}
    uid = rng.integers(0, U, 120).astype(np.int32)
    iid = rng.integers(0, I, 120).astype(np.int32)
    y = (rng.random(120) < 0.5).astype(np.float32)
    want_pu, want_pi, want_losses = jax_mf_fullbatch_train(
        jnp.asarray(uid), jnp.asarray(iid), jnp.asarray(y), jnp.asarray(params["user"]),
        jnp.asarray(params["item"]), 3, LR, WD, compute_dtype, block_rows=64, interpret=True)
    args = [torch.from_numpy(a) for a in (uid, iid, y, params["user"], params["item"])]
    pu, pi, losses = port.mf_fullbatch_train(*args, 3, LR, WD, compute_dtype)
    tol = TOL[compute_dtype]
    assert pu.shape == (U, width) and pi.shape == (I, width)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=tol["rtol"])
    np.testing.assert_allclose(pu.numpy(), np.asarray(want_pu), atol=tol["atol"])
    np.testing.assert_allclose(pi.numpy(), np.asarray(want_pi), atol=tol["atol"])
