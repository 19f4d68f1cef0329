"""The port's embedding gather and its backward against the JAX package's
Pallas kernels (interpret mode on the CPU, as ``tests/test_kernels.py`` runs
them), on the same NumPy inputs.

* ``gather_rows_kernel_plain`` equals ``gather_rows_pallas`` and
  ``gather_mm_fwd_pallas`` bit for bit (a gather moves values, it adds none);
* ``onehot_grad_plain`` matches ``onehot_grad`` within atol 1e-4 in f32 and
  1e-2 with bf16 cotangents (the tolerances of ``tests/test_kernels.py``:
  both sum in f32, in another order);
* ``GatherRows``'s gradient equals ``jax.grad`` through
  ``gather_rows_mm_pallas`` within the same tolerances;
* out-of-range ids follow the JAX package's default route, ``table[ids]``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.ops.pallas import gather_mm as jax_gmm
from deeplearningrecommendationsystem_tpu.ops.pallas.gather import gather_rows_pallas
from deeplearningrecommendationsystem_tpu.ops.pallas.gather_mm import gather_mm_fwd_pallas
from deeplearningrecommendationsystem_tpu.ops.pallas.onehot_grad import onehot_grad as jax_onehot_grad
from deeplearningrecommendationsystem_tpu.parallel.ep import gather_rows as jax_gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops import gather as port
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import GatherRows, gather_rows

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _values(rng, shape, dtype: str) -> np.ndarray:
    """float32 values that the dtype holds exactly, so both packages start equal."""
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(DTYPES[dtype][1]).float().numpy()


def _both(x: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ids(rng, n, V: int) -> np.ndarray:
    """int32 ids into [0, V): ``n`` random ones, or for ``n`` = (rows, L) a DIN
    history batch: rows of one user's L items, each user's row repeated L times
    (rows are user-major, so an id recurs every L ids, never twice in a row)."""
    if isinstance(n, int):
        return rng.integers(0, V, n).astype(np.int32)
    rows, L = n
    users = [rng.choice(V, L, replace=False) for _ in range(rows // L)]
    return np.concatenate([np.tile(items, L) for items in users]).astype(np.int32)


def _count(n) -> int:
    return n if isinstance(n, int) else n[0] * n[1]


# (V, D, B): ragged against the Pallas block sizes, a bias table, the MF user
# width, LR's user-bias table at a ragged batch, DIN's history pattern (40
# rows of 10 ids), DIN's smallest full-history target tile (512 ids)
GATHER_CASES = [(500, 128, 300), (943, 64, 530), (37, 1, 77), (1682, 16, 8), (943, 1, 2_000),
                (300, 16, (40, 10)), (1682, 64, 512)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("V,D,B", GATHER_CASES)
def test_gather_plain_equals_pallas(V, D, B, dtype):
    rng = np.random.default_rng(V + _count(B))
    table = _values(rng, (V, D), dtype)
    ids = _ids(rng, B, V)
    B = _count(B)
    jt, tt = _both(table, dtype)
    got = port.gather_rows_kernel_plain(tt, torch.from_numpy(ids))
    assert got.dtype == tt.dtype and got.shape == (B, D)
    want_dma = gather_rows_pallas(jt, jnp.asarray(ids), block_rows=64, interpret=True)
    want_mm = gather_mm_fwd_pallas(jt, jnp.asarray(ids), block_rows=64, interpret=True)
    np.testing.assert_array_equal(_f32(got), _f32(want_dma))
    np.testing.assert_array_equal(_f32(got), _f32(want_mm))
    np.testing.assert_array_equal(_f32(port.gather_rows_kernel(tt, torch.from_numpy(ids))),
                                  _f32(got))


# the (N, V, D) cases of tests/test_kernels.py::test_onehot_grad_kernel_matches_scatter_add,
# then a bias table at LR's width, DIN's history pattern (40 rows of 10 ids,
# in both dtypes) and a 512-id batch into DIN's item table
GRAD_CASES = [(530, 1682, 16, "float32"), (256, 943, 1, "float32"), (200, 100, 32, "bfloat16"),
              (2_000, 943, 1, "float32"), ((40, 10), 300, 16, "float32"),
              ((40, 10), 300, 16, "bfloat16"), (512, 1682, 64, "float32")]


@pytest.mark.parametrize("N,V,D,dtype", GRAD_CASES)
def test_onehot_grad_plain_matches_pallas(N, V, D, dtype):
    rng = np.random.default_rng(7)
    ids = _ids(rng, N, V)
    N = _count(N)
    g = _values(rng, (N, D), dtype)
    jg, tg = _both(g, dtype)
    want = jax_onehot_grad(jnp.asarray(ids), jg, V, block_rows=128, interpret=True)
    got = port.onehot_grad_plain(torch.from_numpy(ids), tg, V)
    assert got.dtype == torch.float32 and got.shape == (V, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL[dtype])
    np.testing.assert_array_equal(port.onehot_grad(torch.from_numpy(ids), tg, V).numpy(),
                                  got.numpy())


def test_onehot_grad_integer_cotangents_are_exact():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 50, 4000)
    g = rng.integers(-8, 9, (4000, 8)).astype(np.float32)
    want = np.zeros((50, 8), np.float32)
    np.add.at(want, ids, g)
    got = port.onehot_grad_plain(torch.from_numpy(ids), torch.from_numpy(g), 50)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("V,D,N,dtype", [(943, 64, 530, "float32"), (100, 16, 90, "bfloat16")])
def test_gather_rows_grad_matches_pallas_vjp(monkeypatch, V, D, N, dtype):
    """GatherRows (gather kernel forward, onehot_grad backward cast to the
    table's dtype) against jax.grad through gather_rows_mm_pallas."""
    monkeypatch.setattr(jax_gmm, "gather_mm_fwd_pallas",
                        lambda table, ids, _o=jax_gmm.gather_mm_fwd_pallas:
                        _o(table, ids, block_rows=64, interpret=True))
    monkeypatch.setattr(jax_gmm, "onehot_grad",
                        lambda ids, g, vocab, _o=jax_gmm.onehot_grad:
                        _o(ids, g, vocab, block_rows=64, interpret=True))
    rng = np.random.default_rng(V)
    table = _values(rng, (V, D), dtype)
    ids = rng.integers(0, V, (N // 2, 2)).astype(np.int32)  # 2-D ids, as a history batch
    jt, tt = _both(table, dtype)

    def jax_loss(t):
        return jnp.sum(jnp.sin(jax_gmm.gather_rows_mm_pallas(t, jnp.asarray(ids)).astype(jnp.float32)))

    want = jax.grad(jax_loss)(jt)
    tt.requires_grad_(True)
    out = gather_rows(tt, torch.from_numpy(ids))
    assert out.shape == (N // 2, 2, D) and out.dtype == tt.dtype
    torch.sin(out.float()).sum().backward()
    assert tt.grad.dtype == tt.dtype
    np.testing.assert_allclose(_f32(tt.grad), _f32(want), atol=GRAD_ATOL[dtype])


def test_out_of_range_ids_follow_the_jax_default_route():
    """V = 5, ids [7, -1, -9, 2]: JAX's table[ids] (the default route of
    parallel/ep.py::gather_rows) reads rows [4, 4, 0, 2] -- a negative id
    counts from the end once, then the id is clamped -- and its gradient
    drops 7 and -9 (still out of range after the wrap): rows [0, 0, 1, 0, 1]."""
    table = np.arange(10, dtype=np.float32).reshape(5, 2)
    ids = np.array([7, -1, -9, 2], dtype=np.int32)
    want_fwd = jax_gather_rows(jnp.asarray(table), jnp.asarray(ids))
    want_grad = jax.grad(lambda t: jax_gather_rows(t, jnp.asarray(ids)).sum())(jnp.asarray(table))
    np.testing.assert_array_equal(np.asarray(want_fwd), table[[4, 4, 0, 2]])
    np.testing.assert_array_equal(np.asarray(want_grad)[:, 0], [0, 0, 1, 0, 1])

    tt = torch.from_numpy(table).requires_grad_(True)
    out = GatherRows.apply(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(want_fwd))
    out.sum().backward()
    np.testing.assert_array_equal(tt.grad.numpy(), np.asarray(want_grad))


def test_gather_rows_rejects_a_mesh():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        gather_rows(torch.zeros(3, 2), torch.zeros(2, dtype=torch.int64), mesh=object())
