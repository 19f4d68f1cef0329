"""The CUDA kernels against their plain PyTorch versions, on the card: the
serving top-k kernels, the embedding gather and its backward, and the fused MF
trainer. Every test here needs an NVIDIA GPU with nvcc and skips elsewhere; run
them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py tests/test_torch_isolation.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX, which the card's
machine need not have; this file imports neither JAX nor the JAX package.)

Integer-valued inputs make every score exact, so kernel and plain version must
agree bit for bit, ties and the slots past a user's unseen items included. A
gather moves values and must agree bit for bit on any input; ``onehot_grad``
sums with atomics in an order that changes between runs, so it is exact on
integer-valued cotangents and, on normal ones, within the float32 bound of
recursive summation of the exact (float64) sums.
"""

import pytest
import torch

from deeplearningrecommendationsystem_tpu_torch.ops import gather as gat
from deeplearningrecommendationsystem_tpu_torch.ops import mf_epoch as mfe
from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import gather as cuda_gather
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as cuda_mfe
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as cuda_topk
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(cuda, U, I, D, seed, density=0.3):
    g = torch.Generator(device=cuda).manual_seed(seed)
    P = torch.randint(-3, 4, (U, D), generator=g, device=cuda).float()
    Q = torch.randint(-3, 4, (I, D), generator=g, device=cuda).float()
    seen = torch.rand((U, I), generator=g, device=cuda) < density
    return P, Q, seen


def _assert_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# (U, I, D): ragged user tiles and item chunks, a catalog smaller than one
# chunk, exactly one chunk, and widths that are not a multiple of 4
SHAPES = [(37, 301, 16), (1, 100, 64), (9, 128, 7), (70, 1000, 100)]


@pytest.mark.parametrize("U,I,D", SHAPES)
@pytest.mark.parametrize("k", [1, 7, 50, 128])
def test_topk_serve_matmul_equals_plain(cuda, U, I, D, k):
    if k > I:
        pytest.skip("k exceeds the catalog")
    P, Q, seen = _inputs(cuda, U, I, D, seed=U + I + k)
    _assert_equal(topk.topk_serve_matmul(P, Q, seen, k=k),
                  topk.topk_serve_matmul_plain(P, Q, seen, k=k))


@pytest.mark.parametrize("U,I,D", SHAPES)
@pytest.mark.parametrize("k", [1, 7, 50, 128])
def test_topk_scores_equals_plain(cuda, U, I, D, k):
    if k > I:
        pytest.skip("k exceeds the catalog")
    P, Q, seen = _inputs(cuda, U, I, D, seed=U * I + k)
    scores = P @ Q.T
    _assert_equal(topk.topk_scores(scores, seen, k=k), topk.topk_scores_plain(scores, seen, k=k))


@pytest.mark.parametrize("name", ["topk_serve_matmul", "topk_scores"])
def test_user_with_fewer_unseen_items_than_k(cuda, name):
    P, Q, seen = _inputs(cuda, 4, 300, 8, seed=4)
    seen[0] = True
    seen[0, [5, 140, 290]] = False
    args = (P, Q, seen) if name == "topk_serve_matmul" else (P @ Q.T, seen)
    vals, ids = getattr(topk, name)(*args, k=10)
    _assert_equal((vals, ids), getattr(topk, f"{name}_plain")(*args, k=10))
    assert sorted(ids[0, :3].tolist()) == [5, 140, 290]
    assert ids[0, 3:].tolist() == [0, 1, 2, 3, 4, 6, 7]
    assert bool((vals[0, 3:] < -1e29).all())


def test_seen_dtypes(cuda):
    P, Q, seen = _inputs(cuda, 20, 200, 16, seed=9)
    want = topk.topk_serve_matmul_plain(P, Q, seen, k=20)
    for dtype in (torch.bool, torch.int8, torch.uint8):
        _assert_equal(topk.topk_serve_matmul(P, Q, seen.to(dtype), k=20), want)


def test_launchers_check_their_inputs(cuda):
    P, Q, seen = _inputs(cuda, 8, 64, 16, seed=1)
    bad = [
        ((P.double(), Q, seen), {"k": 4}, TypeError),
        ((P, Q, seen.float()), {"k": 4}, TypeError),
        ((P, Q.T.contiguous().T, seen), {"k": 4}, ValueError),  # not contiguous
        ((P, Q[:, :8].contiguous(), seen), {"k": 4}, ValueError),  # widths differ
        ((P, Q, seen[:, :32].contiguous()), {"k": 4}, ValueError),
        ((P, Q, seen), {"k": 129}, ValueError),
        ((P, Q, seen), {"k": 65}, ValueError),  # k > items
        ((P, Q, seen.cpu()), {"k": 4}, ValueError),  # mixed devices
    ]
    for args, kwargs, err in bad:
        with pytest.raises(err):
            cuda_topk.topk_serve_matmul(*args, **kwargs)
    with pytest.raises(ValueError):
        cuda_topk.topk_scores(P @ Q.T, seen, k=0)


# ---- the embedding gather and its backward (csrc/gather.cu)

# (V, D, B): the MF tables at a ragged batch, one id, a bias table, an odd
# width (4-byte copies), a narrow bf16 row (2-byte copies)
GATHER_SHAPES = [(943, 64, 2297), (1682, 64, 1), (37, 1, 77), (50, 7, 300), (100, 16, 1000)]


@pytest.mark.parametrize("V,D,B", GATHER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_gather_rows_equals_plain(cuda, V, D, B, dtype, id_dtype):
    g = torch.Generator(device=cuda).manual_seed(V + B)
    table = torch.randn((V, D), generator=g, device=cuda).to(dtype)
    ids = torch.randint(-V - 3, V + 3, (B,), generator=g, device=cuda).to(id_dtype)  # out of range too
    got = gat.gather_rows_kernel(table, ids)
    assert got.dtype == dtype and got.shape == (B, D)
    assert torch.equal(got, gat.gather_rows_kernel_plain(table, ids))


@pytest.mark.parametrize("N,V,D", [(229_700, 943, 64), (530, 1682, 16), (256, 943, 1), (300, 50, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_grad_integer_cotangents_exact(cuda, N, V, D, dtype):
    g = torch.Generator(device=cuda).manual_seed(N + D)
    ids = torch.sort(torch.randint(-2, V + 2, (N,), generator=g, device=cuda)).values.to(torch.int32)
    ids[::3] = torch.randint(0, V, (len(ids[::3]),), generator=g, device=cuda).to(torch.int32)
    cot = torch.randint(-8, 9, (N, D), generator=g, device=cuda).to(dtype)
    got = gat.onehot_grad(ids, cot, V)
    assert got.dtype == torch.float32 and got.shape == (V, D)
    assert torch.equal(got, gat.onehot_grad_plain(ids, cot, V))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_grad_normal_cotangents_close(cuda, dtype):
    """Each sum within the float32 bound of recursive summation in any order,
    n u sum|g| (n the row's count, u = 2^-24), of the float64 sum."""
    g = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.randint(0, 1682, (50_000,), generator=g, device=cuda)
    cot = torch.randn((50_000, 64), generator=g, device=cuda).to(dtype)
    ref = torch.zeros((1682, 64), dtype=torch.float64, device=cuda).index_add_(0, ids, cot.double())
    mass = torch.zeros_like(ref).index_add_(0, ids, cot.double().abs())
    bound = torch.bincount(ids, minlength=1682).double()[:, None] * 2.0 ** -24 * mass
    for got in (gat.onehot_grad(ids, cot, 1682), gat.onehot_grad_plain(ids, cot, 1682)):
        assert bool(((got.double() - ref).abs() <= bound).all())


def test_gather_rows_autograd_on_the_card(cuda):
    """GatherRows on CUDA tensors: one launch of each kernel, and the table's
    gradient equals the CPU plain versions' on integer cotangent rows."""
    g = torch.Generator(device=cuda).manual_seed(2)
    table = torch.randn((943, 64), generator=g, device=cuda, requires_grad=True)
    ids = torch.randint(0, 943, (4000, 2), generator=g, device=cuda)
    w = torch.randint(-3, 4, (4000, 2, 64), generator=g, device=cuda).float()
    before = cuda_gather.gather_rows.launches, cuda_gather.onehot_grad.launches
    (gather_rows(table, ids) * w).sum().backward()
    torch.cuda.synchronize()
    assert (cuda_gather.gather_rows.launches, cuda_gather.onehot_grad.launches) == (
        before[0] + 1, before[1] + 1)
    cpu_table = table.detach().cpu().requires_grad_(True)
    (gather_rows(cpu_table, ids.cpu()) * w.cpu()).sum().backward()
    assert torch.equal(table.grad.cpu(), cpu_table.grad)


def test_gather_launchers_check_their_inputs(cuda):
    table = torch.randn((10, 8), device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    for args, err in [((table.double(), ids), TypeError), ((table, ids.float()), TypeError),
                      ((table.T, ids), ValueError), ((table, ids[None]), ValueError),
                      ((table, ids.cpu()), ValueError)]:
        with pytest.raises(err):
            cuda_gather.gather_rows(*args)
    with pytest.raises(ValueError):
        cuda_gather.onehot_grad(ids, torch.randn((5, 8), device=cuda), 10)


# ---- the fused MF trainer (csrc/mf_epoch.cu)

def _mf_inputs(cuda, U, I, D, B, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    uid = torch.sort(torch.randint(0, U, (B,), generator=g, device=cuda)).values.to(torch.int32)
    iid = torch.randint(0, I, (B,), generator=g, device=cuda).to(torch.int32)
    y = (torch.rand((B,), generator=g, device=cuda) < 0.3).float()
    pu = 0.1 * torch.randn((U, D), generator=g, device=cuda)
    pi = 0.1 * torch.randn((I, D), generator=g, device=cuda)
    return uid, iid, y, pu, pi


# float32: sums in another order, carried through Adam's normalised steps;
# bfloat16: a gradient row may round to the other bf16 neighbour
MF_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 2e-3)}  # (loss rtol, table atol)


@pytest.mark.parametrize("U,I,D,B", [(50, 81, 16, 300), (943, 1682, 64, 20_000), (7, 9, 100, 33)])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mf_fullbatch_train_matches_plain(cuda, U, I, D, B, compute_dtype):
    args = _mf_inputs(cuda, U, I, D, B, seed=U + B)
    before = cuda_mfe.mf_fullbatch_train.launches
    pu, pi, losses = mfe.mf_fullbatch_train(*args, 6, 0.01, 1e-5, compute_dtype)
    torch.cuda.synchronize()
    assert cuda_mfe.mf_fullbatch_train.launches == before + 12  # two launches an epoch
    want_pu, want_pi, want_losses = mfe.mf_fullbatch_train_plain(*args, 6, 0.01, 1e-5,
                                                                 compute_dtype)
    rtol, atol = MF_TOL[compute_dtype]
    torch.testing.assert_close(losses, want_losses, rtol=rtol, atol=0)
    torch.testing.assert_close(pu, want_pu, rtol=0, atol=atol)
    torch.testing.assert_close(pi, want_pi, rtol=0, atol=atol)


def test_mf_launcher_checks_its_inputs(cuda):
    uid, iid, y, pu, pi = _mf_inputs(cuda, 5, 6, 8, 20, seed=0)
    bad = [
        ((uid.float(), iid, y, pu, pi), TypeError),
        ((uid, iid.long(), y, pu, pi), TypeError),  # ids of two dtypes
        ((uid, iid, y[:5], pu, pi), ValueError),
        ((uid, iid, y, pu, pi[:, :4].contiguous()), ValueError),
        ((uid, iid, y, torch.zeros((5, 129), device=cuda), torch.zeros((6, 129), device=cuda)),
         ValueError),
    ]
    for args, err in bad:
        with pytest.raises(err):
            cuda_mfe.mf_fullbatch_train(*args, 2, 0.01)
    with pytest.raises(ValueError):
        cuda_mfe.mf_fullbatch_train(uid, iid, y, pu, pi, 2, 0.01, compute_dtype="float16")
