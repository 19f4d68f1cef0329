"""The port's GRU and AUGRU (``ops/gru.py``) against the JAX package's, on the
same NumPy inputs and weights: B 32, L 12, D 8, H 8 (and D 6 into H 10, so
that the input and the state widths differ), every step's state and the final
state, with and without an initial state.

Tolerances: float32 atol 1e-6 on states in (-1, 1) (``torch.sigmoid`` and
XLA's ``1 / (1 + exp(-x))`` differ by an ulp; measured 1.8e-7). bfloat16
exactly: the port takes ``jax.nn.sigmoid``'s lowering under bf16, so each op
rounds as the JAX op does (measured 0 ulps; ``torch.sigmoid`` instead put
44% of the states up to 2.5 ulps off).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.ops import gru as jax_gru
from deeplearningrecommendationsystem_tpu_torch.ops import gru as port_gru


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: these tests run many small ops (DIEN's GRU
    steps), for which threads buy nothing alone and, with several test
    workers on one host, each worker's thread pool spinning against the
    others' made them ten times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

B, L = 32, 12
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-6), "bfloat16": (jnp.bfloat16, torch.bfloat16, 0)}


def _inputs(d_in, hidden, seed=0):
    rng = np.random.default_rng(seed)
    p = jax.tree.map(np.asarray, jax_gru.gru_init(jax.random.PRNGKey(seed), d_in, hidden))
    xs = rng.normal(size=(B, L, d_in)).astype(np.float32)
    att = rng.random((B, L)).astype(np.float32)
    att[:4, 7:] = 0.0  # a held state past a sequence's end, as full-history serving gives it
    h0 = rng.uniform(-0.5, 0.5, (B, hidden)).astype(np.float32)
    return p, xs, att, h0


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("fn", ["gru", "augru"])
@pytest.mark.parametrize("widths", [(8, 8), (6, 10)], ids=["d8_h8", "d6_h10"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["h0_zero", "h0_given"])
def test_matches_jax(dtype, fn, widths, with_h0):
    jdt, tdt, atol = DTYPES[dtype]
    p, xs, att, h0 = _inputs(*widths)
    jargs = [jax.tree.map(lambda a: jnp.asarray(a, jdt), p), jnp.asarray(xs, jdt)]
    targs = [{k: torch.from_numpy(np.array(v)).to(tdt) for k, v in p.items()},
             torch.from_numpy(xs).to(tdt)]
    if fn == "augru":
        jargs.append(jnp.asarray(att, jdt))
        targs.append(torch.from_numpy(att).to(tdt))
    kw_j = {"h0": jnp.asarray(h0, jdt)} if with_h0 else {}
    kw_t = {"h0": torch.from_numpy(h0).to(tdt)} if with_h0 else {}
    for seq in (True, False):
        want = np.asarray(jax.jit(functools.partial(getattr(jax_gru, fn), return_sequence=seq,
                                                    **kw_j))(*jargs)).astype(np.float32)
        got = getattr(port_gru, fn)(*targs, return_sequence=seq, **kw_t)
        assert got.dtype == tdt
        assert got.shape == ((B, L, widths[1]) if seq else (B, widths[1]))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol,
                                   err_msg=f"return_sequence={seq}")


def test_sequence_ends_in_the_final_state():
    p, xs, att, _ = _inputs(8, 8)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = torch.from_numpy(xs)
    assert torch.equal(port_gru.gru(tp, x, return_sequence=True)[:, -1], port_gru.gru(tp, x))
    a = torch.from_numpy(att)
    states = port_gru.augru(tp, x, a, return_sequence=True)
    assert torch.equal(states[:, -1], port_gru.augru(tp, x, a))
    # attention 0 holds the state: rows 0-3 keep step 6's state to the end
    assert torch.equal(states[:4, 6:], states[:4, 6:7].expand(4, L - 6, 8))


def test_init_layout_and_bounds():
    p = port_gru.gru_init(torch.Generator().manual_seed(0), 6, 10)
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "w_ih": (6, 30), "w_hh": (10, 30), "b_ih": (30,), "b_hh": (30,)}
    for v in p.values():
        assert float(v.abs().max()) <= 10 ** -0.5
