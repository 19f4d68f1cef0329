"""The port's DIN ops against the JAX package, on the same NumPy inputs and
weights, at a small width (D 16, attention (32, 16, 1), fc (64, 32, 1), L 10).

* ``mlp``, ``din_attention_weights`` and ``attention_pool`` (with and without
  a mask) against their JAX functions (rtol 1e-5, atol 1e-6: float32 sums in
  another order);
* ``din_head_weights`` against ``_weights_tuple`` (exact: the same sums);
* the plain DIN head forward against ``din_head_fused`` in interpret mode at a
  ragged B (70 rows, blocks of 32; rtol and atol 2e-5, the JAX test's);
* ``DinHead``'s gradients, the MLPs' params through the decomposition
  included, against the Pallas custom VJP's (rtol 5e-4, atol 5e-5, the JAX
  test's);
* the plain DIN attention pool against ``din_attention_pool_pallas`` in
  interpret mode (atol 2e-5, as ``tests/test_kernels.py`` holds it);
* the bfloat16 path of the plain DIN head, forward and backward, against the
  Pallas kernels in interpret mode on the same bf16 inputs, at B 37, L 5, D 8,
  attention (8, 4, 1), fc (16, 8, 1): logits within one bf16 ulp each,
  gradients normwise rtol 1e-5 (tighter than the JAX test's 2e-2, which an
  unrounded float32 computation passes); that float32 computation fails both;
* the public wrappers take the plain versions on CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.models import DIN as JaxDIN
from deeplearningrecommendationsystem_tpu.ops import attention as jax_attention
from deeplearningrecommendationsystem_tpu.ops.linear import mlp as jax_mlp
from deeplearningrecommendationsystem_tpu.ops.pallas.din_attention import din_attention_pool_pallas
from deeplearningrecommendationsystem_tpu.ops.pallas.din_head import (
    _call_bwd,
    _weights_tuple,
    din_head_fused,
)
from deeplearningrecommendationsystem_tpu_torch.ops import attention, din_attention
from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp, mlp_init

D, A, F, L, ITEMS = 16, (32, 16, 1), (64, 32, 1), 10, 200


def _torch_tree(tree):
    return [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()} for layer in tree]


@pytest.fixture(scope="module")
def params():
    p = JaxDIN(ITEMS, embed_size=D, attention_units=A, fc_units=F).init(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(B, L, D)).astype(np.float32)
    tgt = rng.normal(size=(B, D)).astype(np.float32)
    cot = rng.normal(size=B).astype(np.float32)
    mask = rng.random((B, L)) < 0.7
    mask[:, -1] = True  # at least one valid position a row
    return hist, tgt, cot, mask


@pytest.mark.parametrize("final_activation", [False, True])
def test_mlp_matches_jax(params, final_activation):
    x = np.random.default_rng(1).normal(size=(9, 2 * D)).astype(np.float32)
    want = jax_mlp(params["fc"], jnp.asarray(x), final_activation=final_activation)
    got = mlp(_torch_tree(params["fc"]), torch.from_numpy(x), final_activation=final_activation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_mlp_init_shapes_and_bounds():
    layers = mlp_init(torch.Generator().manual_seed(0), (3 * D,) + A)
    assert [tuple(p["w"].shape) for p in layers] == [(48, 32), (32, 16), (16, 1)]
    assert [tuple(p["b"].shape) for p in layers] == [(32,), (16,), (1,)]
    for p, fan_in in zip(layers, (48, 32, 16)):
        assert float(p["w"].abs().max()) <= fan_in ** -0.5


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fn", ["din_attention_weights", "attention_pool"])
def test_attention_matches_jax(params, masked, fn):
    hist, tgt, _, mask = _inputs(30, seed=2)
    jmask = jnp.asarray(mask) if masked else None
    want = getattr(jax_attention, fn)(params["att"], jnp.asarray(hist), jnp.asarray(tgt), jmask)
    got = getattr(attention, fn)(_torch_tree(params["att"]), torch.from_numpy(hist),
                                 torch.from_numpy(tgt), torch.from_numpy(mask) if masked else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_head_weights_match_weights_tuple(params):
    want = _weights_tuple(params["att"], params["fc"], D)
    got = dh.din_head_weights(_torch_tree(params["att"]), _torch_tree(params["fc"]), D)
    assert len(got) == len(want) == len(dh.WEIGHT_NAMES) == 14
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_head_weights_need_two_hidden_layers(params):
    att = _torch_tree(params["att"])
    with pytest.raises(ValueError, match="two hidden layers"):
        dh.din_head_weights(att[1:], _torch_tree(params["fc"]), D)
    with pytest.raises(ValueError, match="first layers"):
        dh.din_head_weights(att, _torch_tree(params["fc"]), D + 1)


def test_plain_head_matches_pallas_forward(params):
    hist, tgt, _, _ = _inputs(70, seed=3)  # 70 = 2 x 32 + 6: a ragged last block
    want = din_head_fused(params["att"], params["fc"], jnp.asarray(hist), jnp.asarray(tgt),
                          block_rows=32, interpret=True)
    weights = dh.din_head_weights(_torch_tree(params["att"]), _torch_tree(params["fc"]), D)
    h, t = torch.from_numpy(hist), torch.from_numpy(tgt)
    got = dh.din_head_fwd_plain(h, t, weights)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    # the public wrapper takes the plain version on CPU tensors
    np.testing.assert_allclose(dh.din_head_fwd(h, t, weights).numpy(), got.numpy(),
                               rtol=1e-6, atol=1e-7)
    # and so does the composition it stands for, attention_pool + mlp
    att, fc = _torch_tree(params["att"]), _torch_tree(params["fc"])
    composed = mlp(fc, torch.cat([attention.attention_pool(att, h, t), t], -1))[:, 0]
    np.testing.assert_allclose(got.numpy(), composed.numpy(), rtol=1e-5, atol=1e-6)


def test_head_grads_match_pallas_vjp(params):
    hist, tgt, cot, _ = _inputs(70, seed=4)

    def loss(att, fc, h, t):
        return jnp.sum(din_head_fused(att, fc, h, t, block_rows=32, interpret=True) * cot)

    v_want, g_want = jax.value_and_grad(loss, argnums=(0, 1, 2, 3))(
        params["att"], params["fc"], jnp.asarray(hist), jnp.asarray(tgt))
    att = [{k: v.requires_grad_(True) for k, v in layer.items()} for layer in _torch_tree(params["att"])]
    fc = [{k: v.requires_grad_(True) for k, v in layer.items()} for layer in _torch_tree(params["fc"])]
    h = torch.from_numpy(hist).requires_grad_(True)
    t = torch.from_numpy(tgt).requires_grad_(True)
    v_got = (dh.din_head(att, fc, h, t) * torch.from_numpy(cot)).sum()
    v_got.backward()
    np.testing.assert_allclose(v_got.item(), float(v_want), rtol=1e-5)
    got = [layer[k].grad for net in (att, fc) for layer in net for k in ("w", "b")]
    want = [layer[k] for net in g_want[:2] for layer in net for k in ("w", "b")]
    assert len(got) == len(want) == 12
    for g, w in zip(got + [h.grad, t.grad], want + [g_want[2], g_want[3]]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4, atol=5e-5)
    assert att[0]["w"].grad.shape == (3 * D, A[0]) and fc[0]["w"].grad.shape == (2 * D, F[0])


def test_bwd_wrapper_returns_the_autograd_grads(params):
    hist, tgt, cot, _ = _inputs(33, seed=5)
    weights = [w.clone().requires_grad_(True) for w in
               dh.din_head_weights(_torch_tree(params["att"]), _torch_tree(params["fc"]), D)]
    h = torch.from_numpy(hist).requires_grad_(True)
    t = torch.from_numpy(tgt).requires_grad_(True)
    (dh.DinHead.apply(h, t, *weights) * torch.from_numpy(cot)).sum().backward()
    grads = dh.din_head_bwd(h.detach(), t.detach(), [w.detach() for w in weights],
                            torch.from_numpy(cot))
    assert len(grads) == 2 + len(dh.WEIGHT_NAMES)
    for g, leaf in zip(grads, [h, t, *weights]):
        assert g.shape == leaf.shape
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=1e-6, atol=1e-7)


def test_plain_pool_matches_pallas(params):
    hist, tgt, _, _ = _inputs(100, seed=6)  # 100: not a multiple of the block
    want = din_attention_pool_pallas(jnp.asarray(hist), jnp.asarray(tgt), params["att"],
                                     block_rows=32, interpret=True)
    h, t, att = torch.from_numpy(hist), torch.from_numpy(tgt), _torch_tree(params["att"])
    got = din_attention.din_attention_pool_plain(h, t, att)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(din_attention.din_attention_pool(h, t, att).numpy(), got.numpy(),
                               rtol=1e-6, atol=1e-7)


# ---- the bfloat16 path: the port's plain versions against the Pallas kernels in
# interpret mode on the same bf16 inputs. Both round the same operands to bf16
# and sum in float32, so the logits agree within BF16_ULPS bf16 ulp each and
# the gradients within BF16_RTOL of each tensor's largest |value| (measured: 0
# ulp, 2e-7). The JAX test's normwise 2e-2 (tests/test_din_head_kernel.py::
# test_bf16_inputs_supported) cannot tell rounding from not rounding: the same
# values in float32 throughout are 6e-3 off in the logits (up to 20 ulp) and
# 2e-3 to 1.5e-2 in the gradients, and test_bf16_limits_fail_unrounded_float32
# holds these limits to failing it.

BF16_DIMS = dict(B=37, L=5, D=8, A=(8, 4, 1), F=(16, 8, 1))  # B ragged against blocks of 16
BF16_ULPS, BF16_RTOL = 1, 1e-5
# gradients the rounding moves (d b3 is 0 in exact arithmetic; d c2, d c3 are
# sums of g and of dzf2 alone)
BF16_ROUNDED = ("hist", "target", "wh", "wt", "b1", "w2", "b2", "w3", "u1p", "u1t", "c1",
                "u2", "u3")


def _bf16_case():
    B, L, Dn = BF16_DIMS["B"], BF16_DIMS["L"], BF16_DIMS["D"]
    p = JaxDIN(ITEMS, embed_size=Dn, attention_units=BF16_DIMS["A"],
               fc_units=BF16_DIMS["F"]).init(jax.random.PRNGKey(1))
    p = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), p)
    rng = np.random.default_rng(11)
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))  # noqa: E731
    hist = bf(0.5 * rng.normal(size=(B, L, Dn)))
    tgt = bf(0.5 * rng.normal(size=(B, Dn)))
    cot = bf(rng.normal(size=B))
    to_t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    tree = [{k: to_t(v) for k, v in layer.items()} for layer in p["att"]], \
        [{k: to_t(v) for k, v in layer.items()} for layer in p["fc"]]
    return p, (hist, tgt, cot), tree, (to_t(hist), to_t(tgt), to_t(cot))


def _normwise(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _ulps(got, want):
    """Largest |got - want| in bf16 ulps of each element of ``want``."""
    want = torch.as_tensor(np.asarray(want, np.float32))
    _, e = torch.frexp(want.abs())  # |want| = m 2^e, m in [0.5, 1): ulp 2^(e - 8)
    return float(((torch.as_tensor(np.asarray(got, np.float32)) - want).abs()
                  / torch.ldexp(torch.ones_like(want), e - 8)).max())


def test_bf16_plain_head_forward_matches_pallas():
    p, (hist, tgt, _), (att, fc), (h, t, _) = _bf16_case()
    want = din_head_fused(p["att"], p["fc"], jnp.asarray(hist), jnp.asarray(tgt),
                          block_rows=16, interpret=True)
    assert want.dtype == jnp.bfloat16
    weights = dh.din_head_weights(att, fc, BF16_DIMS["D"])
    got = dh.din_head_fwd_plain(h, t, weights)
    assert got.dtype == torch.bfloat16 and got.shape == (BF16_DIMS["B"],)
    assert _ulps(got.float().numpy(), want) <= BF16_ULPS
    assert torch.equal(dh.din_head_fwd(h, t, weights), got)  # the wrapper on CPU tensors


def test_bf16_plain_head_backward_matches_pallas():
    """``din_head_bwd_plain`` against ``_call_bwd`` (the Pallas backward's float32
    outputs, before its cast). d b3 is 0 in exact arithmetic and held to 1e-4 of
    sum |g|, as rounding noise."""
    p, (hist, tgt, cot), (att, fc), (h, t, g) = _bf16_case()
    jweights = _weights_tuple(p["att"], p["fc"], BF16_DIMS["D"])
    want = _call_bwd(jnp.asarray(hist), jnp.asarray(tgt), tuple(jnp.asarray(w) for w in jweights),
                     jnp.asarray(cot), 16, True)
    weights = dh.din_head_weights(att, fc, BF16_DIMS["D"])
    got = dh.din_head_bwd_plain(h, t, weights, g)
    names = ("hist", "target") + dh.WEIGHT_NAMES
    assert len(got) == len(want) == len(names)
    for name, gt, wt in zip(names, got, want):
        assert gt.dtype == torch.float32 and tuple(gt.shape) == tuple(wt.shape), name
        if name == "b3":
            assert abs(float(gt) - float(wt[0, 0])) <= 1e-4 * float(np.abs(cot.astype(np.float32)).sum())
        else:
            assert _normwise(gt.numpy(), wt) <= BF16_RTOL, f"d{name}"


def test_bf16_limits_fail_unrounded_float32():
    """The bf16 limits above tell rounding from not rounding: the same bf16
    values through the plain head in float32 throughout (no operand rounded)
    miss the bf16 plain version's logits by more than BF16_ULPS and each
    rounded gradient by more than 10 x BF16_RTOL."""
    _, _, (att, fc), (h, t, g) = _bf16_case()
    weights = dh.din_head_weights(att, fc, BF16_DIMS["D"])
    w32 = tuple(w.float() for w in weights)
    bf16 = dh.din_head_fwd_plain(h, t, weights).float().numpy()
    f32 = dh.din_head_fwd_plain(h.float(), t.float(), w32).to(torch.bfloat16).float().numpy()
    assert _ulps(f32, bf16) > BF16_ULPS
    got = dict(zip(("hist", "target") + dh.WEIGHT_NAMES, dh.din_head_bwd_plain(h, t, weights, g)))
    unrounded = dict(zip(("hist", "target") + dh.WEIGHT_NAMES,
                         dh.din_head_bwd_plain(h.float(), t.float(), w32, g.float())))
    for name in BF16_ROUNDED:
        assert _normwise(unrounded[name].numpy(), got[name].numpy()) > 10 * BF16_RTOL, name
