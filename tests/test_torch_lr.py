"""The port's LR against the JAX package's, on the same NumPy inputs and weights.

* ``apply`` (the gather route) and the ``wide_input`` route on ``widen(x)``;
* the plain fused trainers against the JAX Pallas kernels in interpret mode,
  on the same padded arrays the JAX ``fast_fit`` builds (block_rows=64, B = 90
  ragged): losses rtol 1e-5, weights atol 1e-5, as
  ``tests/test_kernels.py::test_lr_fast_fit_matches_trainer`` holds them;
* the port's ``fast_fit`` (both modes) against the port's ``Trainer``;
* ``serving_factors`` against ``score_catalog``;
* ids outside the weight segments.

Logits rtol 1e-6 (the same float32 products and sums in another library).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.models import LogisticRegression as JaxLR
from deeplearningrecommendationsystem_tpu.ops.pallas import lr_epoch as jax_lre
from deeplearningrecommendationsystem_tpu_torch.features import ML100K_SPEC, FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models import LogisticRegression, ServingContext
from deeplearningrecommendationsystem_tpu_torch.ops import lr_epoch
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

U, I, D = ML100K_SPEC.num_users, ML100K_SPEC.num_items, ML100K_SPEC.dense_width
B, EPOCHS, LR = 90, 6, 0.05
LOSS_RTOL, W_ATOL = 1e-5, 1e-5


def _features(rng, n):
    """As ``tests/test_kernels.py``'s LR tests: ids, then 43 uniform columns."""
    x = np.zeros((n, 45), np.float32)
    x[:, 0] = rng.integers(0, U, n)
    x[:, 1] = rng.integers(0, I, n)
    x[:, 2:] = rng.random((n, 43))
    return x


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    params = jax.tree.map(np.asarray, JaxLR().init(jax.random.PRNGKey(3)))
    x = _features(rng, B)
    y = (rng.random(B) < 0.5).astype(np.float32)
    return params, x, y


def _model(params, **kw):
    return params_from_jax(LogisticRegression(ML100K_SPEC, device="cpu", **kw), params)


def test_apply_matches_jax(inputs):
    params, x, _ = inputs
    want = JaxLR().apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    model = _model(params)
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert {k: tuple(v.shape) for k, v in model.named_parameters()} == {
        "user_bias": (U, 1), "item_bias": (I, 1), "wide.w": (D, 1), "wide.b": (1,)}


def test_wide_input_matches_jax(inputs):
    params, x, _ = inputs
    jax_wide = JaxLR(wide_input=True)
    xw_want = jax_wide.widen(jnp.asarray(x))
    want = jax_wide.apply(jax.tree.map(jnp.asarray, params), xw_want)
    model = _model(params, wide_input=True)
    xw = model.widen(torch.from_numpy(x))
    np.testing.assert_array_equal(xw.numpy(), np.asarray(xw_want))
    got = model.apply_params(model.params(), xw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the wide route scores the catalog like the gather route
    ctx = ServingContext(torch.rand(U, 24), (torch.rand(I, 19) < 0.2).float())
    with torch.no_grad():
        np.testing.assert_allclose(model.score_catalog(ctx)[:3].numpy(),
                                   _model(params).score_catalog(ctx)[:3].numpy(), atol=1e-6)


def _wide_arrays(params, x):
    """x_aug [B, F_pad] and w0 [F_pad, 1] as the JAX fast_fit(mode="wide") pads them."""
    xw = np.asarray(JaxLR().widen(jnp.asarray(x)))
    F = U + I + D + 1
    F_pad = -(-F // 128) * 128
    x_aug = np.zeros((x.shape[0], F_pad), np.float32)
    x_aug[:, :F - 1] = xw
    x_aug[:, F - 1] = 1.0
    w0 = np.zeros((F_pad, 1), np.float32)
    w0[:F, 0] = np.concatenate([params["user_bias"][:, 0], params["item_bias"][:, 0],
                                params["wide"]["w"][:, 0], params["wide"]["b"]])
    return x_aug, w0


def _compact_arrays(params, x):
    """(uid, iid, dense_aug, w0, u_pad, i_pad) as the JAX fast_fit(mode="compact") pads them."""
    u_pad, i_pad, d_pad = (-(-n // 128) * 128 for n in (U, I, D + 1))
    dense_aug = np.zeros((x.shape[0], d_pad), np.float32)
    dense_aug[:, :D] = x[:, 2:]
    dense_aug[:, D] = 1.0
    w0 = np.zeros((1, u_pad + i_pad + d_pad), np.float32)
    w0[0, :U] = params["user_bias"][:, 0]
    w0[0, u_pad:u_pad + I] = params["item_bias"][:, 0]
    w0[0, u_pad + i_pad:u_pad + i_pad + D] = params["wide"]["w"][:, 0]
    w0[0, u_pad + i_pad + D] = params["wide"]["b"][0]
    return x[:, 0].astype(np.int32), x[:, 1].astype(np.int32), dense_aug, w0, u_pad, i_pad


def test_plain_wide_matches_pallas(inputs):
    params, x, y = inputs
    x_aug, w0 = _wide_arrays(params, x)
    want_w, want_losses = jax_lre.lr_fullbatch_train(
        jnp.asarray(x_aug), jnp.asarray(y), jnp.asarray(w0), EPOCHS, LR, block_rows=64,
        interpret=True)
    args = [torch.from_numpy(a) for a in (x_aug, y, w0)]
    w, losses = lr_epoch.lr_fullbatch_train_plain(*args, EPOCHS, LR)
    assert w.shape == w0.shape and losses.shape == (EPOCHS,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=LOSS_RTOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=0, atol=W_ATOL)
    # the public wrapper takes the plain version on CPU tensors (equal to the last
    # bits: the CPU's threaded reductions may add in another order between calls)
    for a, b in zip(lr_epoch.lr_fullbatch_train(*args, EPOCHS, LR), (w, losses)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-8)


def _compact_pair(uid, iid, dense_aug, y, w0, u_pad, i_pad, epochs=EPOCHS):
    want = jax_lre.lr_fullbatch_train_compact(
        jnp.asarray(uid), jnp.asarray(iid), jnp.asarray(dense_aug), jnp.asarray(y),
        jnp.asarray(w0), epochs, LR, u_pad=u_pad, i_pad=i_pad, block_rows=64, interpret=True)
    got = lr_epoch.lr_fullbatch_train_compact(
        *[torch.from_numpy(a) for a in (uid, iid, dense_aug, y, w0)], epochs, LR, u_pad, i_pad)
    return got, want


def test_plain_compact_matches_pallas(inputs):
    params, x, y = inputs
    uid, iid, dense_aug, w0, u_pad, i_pad = _compact_arrays(params, x)
    (w, losses), (want_w, want_losses) = _compact_pair(uid, iid, dense_aug, y, w0, u_pad, i_pad)
    assert w.shape == w0.shape
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=LOSS_RTOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=0, atol=W_ATOL)


def test_compact_ids_outside_the_segments(inputs):
    """An id matches the lane of its segment when it lies in [0, u_pad): on the
    padded JAX layout, id U + 5 trains the padded lane U + 5 in both packages,
    and ids -1 and u_pad match none. The port's fast_fit pads nothing (u_pad =
    U), so there an id outside [0, U) matches no row: its run equals the run
    with that id set to -1."""
    params, x, y = inputs
    uid, iid, dense_aug, w0, u_pad, i_pad = _compact_arrays(params, x)
    uid = uid.copy()
    uid[:3] = [U + 5, -1, u_pad]
    iid = iid.copy()
    iid[3] = i_pad + 2
    (w, losses), (want_w, want_losses) = _compact_pair(uid, iid, dense_aug, y, w0, u_pad, i_pad)
    np.testing.assert_allclose(losses.numpy(), np.asarray(want_losses), rtol=LOSS_RTOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), rtol=0, atol=W_ATOL)
    assert w[0, U + 5] != 0 and not bool(w[0, U:U + 5].any())

    model = _model(params)
    xo = x.copy()
    xo[:3, 0] = [U + 5, -1, u_pad]
    xn = xo.copy()
    xn[:3, 0] = -1
    got, _ = model.fast_fit(model.params(), torch.from_numpy(xo), torch.from_numpy(y), 3, LR)
    want, _ = model.fast_fit(model.params(), torch.from_numpy(xn), torch.from_numpy(y), 3, LR)
    for k in want:  # to the last bits, as above
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-8,
                                   err_msg=k)


@pytest.mark.parametrize("mode", ["compact", "wide"])
def test_fast_fit_matches_trainer(inputs, mode):
    params, x, y = inputs
    model = _model(params)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got, losses = model.fast_fit(model.params(), xt, yt, EPOCHS, LR, mode=mode)
    # fast_fit leaves the module's own parameters as they are
    np.testing.assert_array_equal(model.user_bias.detach().numpy(), params["user_bias"])
    want = Trainer(model, TrainConfig(learning_rate=LR, epochs=EPOCHS, track_metrics=False),
                   device="cpu").fit((xt, yt))
    np.testing.assert_allclose(losses.numpy(), want.history["train_loss"].numpy(), rtol=LOSS_RTOL)
    assert got.keys() == want.params.keys()
    for k in got:
        assert got[k].shape == want.params[k].shape
        np.testing.assert_allclose(got[k].numpy(), want.params[k].numpy(), atol=W_ATOL, err_msg=k)


def test_fast_fit_rejects_other_modes(inputs):
    params, x, y = inputs
    model = _model(params)
    with pytest.raises(ValueError, match="mode"):
        model.fast_fit(model.params(), torch.from_numpy(x), torch.from_numpy(y), 1, LR, mode="x")


def test_serving_factors_match_score_catalog(inputs):
    params, _, _ = inputs
    nu, ni = 70, 90
    spec = FeatureSpec(num_users=nu, num_items=ni)
    p = {"user_bias": params["user_bias"][:nu], "item_bias": params["item_bias"][:ni],
         "wide": params["wide"]}
    model = params_from_jax(LogisticRegression(spec, device="cpu"), p)
    rng = np.random.default_rng(7)
    uf = np.concatenate([rng.random((nu, 1)), np.eye(2)[rng.integers(0, 2, nu)],
                         np.eye(21)[rng.integers(0, 21, nu)]], 1).astype(np.float32)
    itf = (rng.random((ni, 19)) < 0.2).astype(np.float32)
    ctx = ServingContext(torch.from_numpy(uf), torch.from_numpy(itf))
    with torch.no_grad():
        P, Q = model.serving_factors(ctx)
        scores = model.score_catalog(ctx)
    assert P.shape == (nu, 2) and Q.shape == (ni, 2)
    np.testing.assert_allclose((P @ Q.T).numpy(), scores.numpy(), atol=1e-6)
