"""The CUDA kernels against their plain PyTorch versions, on the card: the
serving top-k kernels, the embedding gather and its backward, the fused MF
trainer, the fused LR trainers (wide and compact), the AFM attention pool
(forward and backward), the fused DIN head (forward and backward) and the DIN
attention pool. Every test here needs an NVIDIA GPU with nvcc and skips elsewhere; run
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

from deeplearningrecommendationsystem_tpu_torch.ops import afm_attention as afm
from deeplearningrecommendationsystem_tpu_torch.ops import din_attention as dinatt
from deeplearningrecommendationsystem_tpu_torch.ops import din_head as dh
from deeplearningrecommendationsystem_tpu_torch.ops import gather as gat
from deeplearningrecommendationsystem_tpu_torch.ops import lr_epoch as lre
from deeplearningrecommendationsystem_tpu_torch.ops import mf_epoch as mfe
from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import afm_attention as cuda_afm
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_attention as cuda_dinatt
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as cuda_dh
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import gather as cuda_gather
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import lr_epoch as cuda_lre
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as cuda_mfe
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as cuda_topk
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp_init

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
# chunk, exactly one chunk, widths that are not a multiple of 4, and LR's
# rank-2 serving factors over the ml-100k catalog
SHAPES = [(37, 301, 16), (1, 100, 64), (9, 128, 7), (70, 1000, 100), (943, 1682, 2)]


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


def _within_summation_bound(got, ids, cot, V):
    """Each sum within the float32 bound of recursive summation in any order,
    n u sum|g| (n the row's count, u = 2^-24), of the float64 sum; ids outside
    [0, V) after one wrap are dropped."""
    idx = ids.long()
    idx = torch.where(idx < 0, idx + V, idx)
    keep = (idx >= 0) & (idx < V)
    idx, cot = idx[keep], cot[keep].double()
    ref = torch.zeros((V, cot.shape[1]), dtype=torch.float64, device=cot.device)
    ref.index_add_(0, idx, cot)
    mass = torch.zeros_like(ref).index_add_(0, idx, cot.abs())
    bound = torch.bincount(idx, minlength=V).double()[:, None] * 2.0 ** -24 * mass
    return bool(((got.double() - ref).abs() <= bound).all())


@pytest.mark.parametrize("D", [1, 2, 3, 8, 31, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_lookup_pair_at_narrow_and_odd_widths(cuda, D, dtype, id_dtype):
    """Rows narrower than a warp (lanes on rows, shuffle sums) and just wider
    (lanes on columns, a second pass for column 32): the gather bit-equal, the
    backward exact on integer cotangents and within the summation bound on
    normal ones, ids out of range mixed in."""
    V, N = 97, 3000
    g = torch.Generator(device=cuda).manual_seed(D * 10 + dtype.itemsize)
    table = torch.randn((V, D), generator=g, device=cuda).to(dtype)
    ids = torch.randint(-V - 2, V + 2, (N,), generator=g, device=cuda).to(id_dtype)
    assert torch.equal(gat.gather_rows_kernel(table, ids), gat.gather_rows_kernel_plain(table, ids))
    cot = torch.randint(-8, 9, (N, D), generator=g, device=cuda).to(dtype)
    assert torch.equal(gat.onehot_grad(ids, cot, V), gat.onehot_grad_plain(ids, cot, V))
    cot = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    assert _within_summation_bound(gat.onehot_grad(ids, cot, V), ids, cot.float(), V)


def _id_pattern(name, N, V, cuda):
    """N ids into [0, V): all equal; two alternating; or a DIN history batch
    (rows of one user's 10 items, 10 rows a user) with out-of-range ids mixed in."""
    if name == "equal":
        return torch.full((N,), 5, device=cuda)
    if name == "alternating":
        return torch.tensor([3, V - 1], device=cuda).repeat(N // 2)
    g = torch.Generator(device=cuda).manual_seed(N)
    items = torch.randint(0, V, (N // 100, 1, 10), generator=g, device=cuda)
    ids = items.expand(-1, 10, -1).reshape(-1).clone()
    ids[::37] = V + 4
    ids[5::41] = -V - 1
    ids[7::43] = -1
    return ids


@pytest.mark.parametrize("pattern", ["equal", "alternating", "history"])
@pytest.mark.parametrize("D", [1, 64, 1030])  # 1030: split groups go to the table directly
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_onehot_grad_repeated_id_patterns(cuda, pattern, D, id_dtype):
    """Ids that repeat inside a tile, within a warp and across warps: the
    on-chip group sums and the split-group buffer must give the plain sums."""
    V, N = 300, 20_000
    ids = _id_pattern(pattern, N, V, cuda).to(id_dtype)
    g = torch.Generator(device=cuda).manual_seed(D)
    cot = torch.randint(-8, 9, (ids.shape[0], D), generator=g, device=cuda).float()
    assert torch.equal(gat.onehot_grad(ids, cot, V), gat.onehot_grad_plain(ids, cot, V))
    cot = torch.randn((ids.shape[0], D), generator=g, device=cuda)
    assert _within_summation_bound(gat.onehot_grad(ids, cot, V), ids, cot, V)
    table = torch.randn((V, D), generator=g, device=cuda)
    assert torch.equal(gat.gather_rows_kernel(table, ids), gat.gather_rows_kernel_plain(table, ids))


def test_lookup_pair_runs_on_the_callers_stream(cuda):
    """Under ``torch.cuda.stream(s)`` both kernels (and the backward's zero
    fill) go on s: their inputs are written on s after a sleep, so a launch on
    any other stream would read them before they are written."""
    V, D, N = 50, 16, 4000
    g = torch.Generator(device=cuda).manual_seed(0)
    src = torch.randn((V, D), generator=g, device=cuda)
    cot_src = torch.randint(-8, 9, (N, D), generator=g, device=cuda).float()
    ids = torch.randint(0, V, (N,), generator=g, device=cuda)
    table, cot = torch.zeros_like(src), torch.zeros_like(cot_src)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        table.copy_(src)
        cot.copy_(cot_src)
        out = gat.gather_rows_kernel(table, ids)
        grad = gat.onehot_grad(ids, cot, V)
    side.synchronize()
    assert torch.equal(out, src[ids])
    assert torch.equal(grad, gat.onehot_grad_plain(ids, cot_src, V))


def test_onehot_grad_of_an_empty_batch_is_zeros(cuda):
    """No rows: no kernel launch, and the output is the memset's zeros (in a
    block the allocator has just freed with other values in it)."""
    stale = torch.full((30, 8), 7.0, device=cuda)
    del stale
    before = cuda_gather.onehot_grad.launches
    got = gat.onehot_grad(torch.zeros(0, dtype=torch.int64, device=cuda),
                          torch.zeros((0, 8), device=cuda), 30)
    torch.cuda.synchronize()
    assert cuda_gather.onehot_grad.launches == before
    assert got.shape == (30, 8) and not bool(got.any())


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


# ---- the fused LR trainers (csrc/lr_epoch.cu)

# losses rtol, weights atol: float32 sums in another order (per-block partials,
# shared atomics) carried through Adam's normalised steps at lr 0.05
LR_TOL = (1e-5, 1e-4)


def _lr_inputs(cuda, B, U, I, D, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    uid = torch.sort(torch.randint(0, U, (B,), generator=g, device=cuda)).values
    iid = torch.randint(0, I, (B,), generator=g, device=cuda)
    dense = (torch.rand((B, D), generator=g, device=cuda) < 0.2).float()
    dense[:, 0] = torch.rand((B,), generator=g, device=cuda)  # the age column
    y = (torch.rand((B,), generator=g, device=cuda) < 0.3).float()
    return uid, iid, dense, y


# (B, U, I): a ragged batch, the LR preset's train batch at ml-100k's width
LR_SHAPES = [(90, 50, 81), (69_040, 943, 1682), (33, 7, 9)]


@pytest.mark.parametrize("B,U,I", LR_SHAPES)
def test_lr_fullbatch_train_matches_plain(cuda, B, U, I):
    uid, iid, dense, y = _lr_inputs(cuda, B, U, I, 43, seed=B)
    x_aug = torch.zeros((B, U + I + 44), device=cuda)
    x_aug[torch.arange(B, device=cuda), uid] = 1.0
    x_aug[torch.arange(B, device=cuda), U + iid] = 1.0
    x_aug[:, U + I:U + I + 43] = dense
    x_aug[:, -1] = 1.0
    w0 = 0.1 * torch.randn((U + I + 44, 1), generator=torch.Generator(device=cuda).manual_seed(1),
                           device=cuda)
    before = cuda_lre.lr_fullbatch_train.launches
    w, losses = lre.lr_fullbatch_train(x_aug, y, w0, 6, 0.05)
    torch.cuda.synchronize()
    assert cuda_lre.lr_fullbatch_train.launches == before + 12  # two launches an epoch
    want_w, want_losses = lre.lr_fullbatch_train_plain(x_aug, y, w0, 6, 0.05)
    torch.testing.assert_close(losses, want_losses, rtol=LR_TOL[0], atol=0)
    torch.testing.assert_close(w, want_w, rtol=0, atol=LR_TOL[1])
    # the same weights every run: the partial sums are reduced in a fixed order
    assert torch.equal(lre.lr_fullbatch_train(x_aug, y, w0, 6, 0.05)[0], w)


@pytest.mark.parametrize("B,U,I", LR_SHAPES)
@pytest.mark.parametrize("padded", [False, True])
def test_lr_fullbatch_train_compact_matches_plain(cuda, B, U, I, padded):
    uid, iid, dense, y = _lr_inputs(cuda, B, U, I, 43, seed=B + 1)
    # the JAX layout pads each segment to 128 lanes; the port's fast_fit pads none
    u_pad, i_pad, d_pad = ((-(-U // 128) * 128, -(-I // 128) * 128, 128) if padded
                           else (U, I, 44))
    dense_aug = torch.zeros((B, d_pad), device=cuda)
    dense_aug[:, :43] = dense
    dense_aug[:, 43] = 1.0
    uid, iid = uid.clone(), iid.clone()
    uid[:3] = torch.tensor([-1, u_pad, u_pad + 5], device=cuda)  # match no lane
    w0 = torch.zeros((1, u_pad + i_pad + d_pad), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    w0[0, :U] = 0.1 * torch.randn(U, generator=g, device=cuda)
    w0[0, u_pad:u_pad + I] = 0.1 * torch.randn(I, generator=g, device=cuda)
    w0[0, u_pad + i_pad:u_pad + i_pad + 44] = 0.1 * torch.randn(44, generator=g, device=cuda)
    for ids in (torch.int32, torch.int64):
        args = (uid.to(ids), iid.to(ids), dense_aug, y, w0, 5, 0.05, u_pad, i_pad)
        before = cuda_lre.lr_fullbatch_train_compact.launches
        w, losses = lre.lr_fullbatch_train_compact(*args)
        torch.cuda.synchronize()
        assert cuda_lre.lr_fullbatch_train_compact.launches == before + 10
        want_w, want_losses = lre.lr_fullbatch_train_compact_plain(*args)
        torch.testing.assert_close(losses, want_losses, rtol=LR_TOL[0], atol=0)
        torch.testing.assert_close(w, want_w, rtol=0, atol=LR_TOL[1])
        if padded:  # lanes no id matches keep their value
            assert not bool(w[0, U:u_pad].any()) and not bool(w[0, u_pad + i_pad + 44:].any())


def test_lr_launchers_check_their_inputs(cuda):
    uid, iid, dense, y = _lr_inputs(cuda, 20, 5, 6, 4, seed=0)
    x = torch.randn((20, 16), device=cuda)
    w0 = torch.zeros((16, 1), device=cuda)
    for args, err in [((x.double(), y, w0), TypeError), ((x, y[:5], w0), ValueError),
                      ((x, y, w0[:8].contiguous()), ValueError), ((x.T, y, w0), ValueError),
                      ((x.cpu(), y, w0), ValueError)]:
        with pytest.raises(err):
            cuda_lre.lr_fullbatch_train(*args, 2, 0.05)
    wc = torch.zeros((1, 5 + 6 + 4), device=cuda)
    for args, err in [((uid.float(), iid, dense, y, wc), TypeError),
                      ((uid, iid.int(), dense, y, wc), TypeError),
                      ((uid, iid, dense, y, wc[:, :10].contiguous()), ValueError),
                      ((uid, iid, torch.zeros((20, 129), device=cuda), y,
                        torch.zeros((1, 140), device=cuda)), ValueError)]:
        with pytest.raises(err):
            cuda_lre.lr_fullbatch_train_compact(*args, 2, 0.05, 5, 6)


# ---- the AFM attention pool (csrc/afm_attention.cu)

def _afm_inputs(cuda, B, D, A, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    fields = 0.3 * torch.randn((B, 6, D), generator=g, device=cuda)
    w = torch.randn((D, A), generator=g, device=cuda)
    b = torch.randn((A,), generator=g, device=cuda)
    h = torch.randn((A, 1), generator=g, device=cuda)
    cot = torch.randn((B, D), generator=g, device=cuda)
    return fields, w, b, h, cot


def _close(got, want, rtol):
    """Within rtol of the tensor's largest |value|: float32 sums over up to
    15 B terms in another order than the plain version's."""
    err = float((got - want).abs().max())
    assert err <= rtol * max(float(want.abs().max()), 1e-30), (err, float(want.abs().max()))


# (B, D, A): the JAX test's shape, the AFM preset's width at a ragged batch
# and at one catalog tile of 64 users, widths that need padding
AFM_SHAPES = [(70, 32, 16), (5_003, 128, 64), (107_648, 128, 64), (301, 7, 5), (40, 64, 128)]


@pytest.mark.parametrize("B,D,A", AFM_SHAPES)
def test_afm_attention_pool_matches_plain(cuda, B, D, A):
    fields, w, b, h, _ = _afm_inputs(cuda, B, D, A, seed=B + D)
    before = cuda_afm.afm_attention_pool.launches
    got = afm.afm_attention_pool(fields, w, b, h)
    torch.cuda.synchronize()
    assert cuda_afm.afm_attention_pool.launches == before + 1
    assert got.shape == (B, D) and got.dtype == torch.float32
    _close(got, afm.afm_attention_pool_plain(fields, w, b, h), 1e-5)


@pytest.mark.parametrize("B,D,A", [s for s in AFM_SHAPES if s[0] < 100_000])
def test_afm_attention_pool_bwd_matches_plain(cuda, B, D, A):
    fields, w, b, h, cot = _afm_inputs(cuda, B, D, A, seed=B + A)
    before = cuda_afm.afm_attention_pool_bwd.launches
    got = afm.afm_attention_pool_bwd(fields, w, b, h, cot)
    torch.cuda.synchronize()
    assert cuda_afm.afm_attention_pool_bwd.launches == before + 2
    want = afm.afm_attention_pool_bwd_plain(fields, w, b, h, cot)
    for gt, wt in zip(got, want):
        assert gt.shape == wt.shape and gt.dtype == torch.float32
        _close(gt, wt, 1e-4)
    # the same gradients every run: the block partials are summed in a fixed order
    for a, b_ in zip(afm.afm_attention_pool_bwd(fields, w, b, h, cot), got):
        assert torch.equal(a, b_)


def test_afm_attention_pool_autograd_on_the_card(cuda):
    """AfmAttentionPool under autograd: one forward and two backward launches,
    the gradients those of the CPU plain versions."""
    fields, w, b, h, cot = _afm_inputs(cuda, 300, 32, 16, seed=3)
    leaves = [t.clone().requires_grad_(True) for t in (fields, w, b, h)]
    before = cuda_afm.afm_attention_pool.launches, cuda_afm.afm_attention_pool_bwd.launches
    (afm.AfmAttentionPool.apply(*leaves) * cot).sum().backward()
    torch.cuda.synchronize()
    assert (cuda_afm.afm_attention_pool.launches, cuda_afm.afm_attention_pool_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    cpu = [t.detach().cpu().requires_grad_(True) for t in (fields, w, b, h)]
    (afm.AfmAttentionPool.apply(*cpu) * cot.cpu()).sum().backward()
    for got, want in zip(leaves, cpu):
        _close(got.grad.cpu(), want.grad, 1e-4)


def test_afm_launchers_check_their_inputs(cuda):
    fields, w, b, h, cot = _afm_inputs(cuda, 10, 8, 4, seed=0)
    for args, err in [((fields.double(), w, b, h), TypeError),
                      ((fields[:, :5].contiguous(), w, b, h), ValueError),
                      ((fields, w[:4].contiguous(), b, h), ValueError),
                      ((fields, w, b[:2].contiguous(), h), ValueError),
                      ((fields.transpose(0, 1), w, b, h), ValueError),
                      ((fields, torch.zeros((8, 129), device=cuda), torch.zeros(129, device=cuda),
                        torch.zeros((129, 1), device=cuda)), ValueError)]:
        with pytest.raises(err):
            cuda_afm.afm_attention_pool(*args)
    with pytest.raises(ValueError):
        cuda_afm.afm_attention_pool_bwd(fields, w, b, h, cot[:5].contiguous())


# ---- the fused DIN head and the DIN attention pool (csrc/din_head.cu, din_attention.cu)

def _din_inputs(cuda, B, L, D, A, F, seed):
    """Embeddings at the scale of the model's tables, the two MLPs as DIN draws
    them (biases included), and a logit cotangent."""
    gen = torch.Generator().manual_seed(seed)
    att = mlp_init(gen, (3 * D,) + A)
    fc = mlp_init(gen, (2 * D,) + F)
    att = [{k: v.to(cuda) for k, v in layer.items()} for layer in att]
    fc = [{k: v.to(cuda) for k, v in layer.items()} for layer in fc]
    g = torch.Generator(device=cuda).manual_seed(seed)
    hist = 0.5 * torch.randn((B, L, D), generator=g, device=cuda)
    tgt = 0.5 * torch.randn((B, D), generator=g, device=cuda)
    cot = torch.randn((B,), generator=g, device=cuda)
    return att, fc, hist, tgt, cot


# (B, L, D, (A1, A2, 1), (F1, F2, 1)): the CPU tests' width at a ragged batch,
# the DIN preset at a ragged batch and at one window tile of 16 users, odd
# history lengths (the longest the kernels take among them) and narrow widths
DIN_SHAPES = [(70, 10, 16, (32, 16, 1), (64, 32, 1)),
              (5_003, 10, 64, (128, 64, 1), (256, 128, 1)),
              (26_912, 10, 64, (128, 64, 1), (256, 128, 1)),
              (301, 7, 8, (12, 8, 1), (20, 12, 1)),
              (40, 64, 16, (16, 8, 1), (16, 8, 1))]


DB3 = 8  # d b3 among (d hist, d target, d wh, d wt, d b1, d w2, d b2, d w3, d b3, ...)


def _close_db3(got, want, cot):
    """d b3 = sum of ds, which is 0 in exact arithmetic (the softmax does not
    see a shift of every score): both versions give rounding noise, held to
    1e-6 of sum |g|."""
    assert float((got - want).abs().max()) <= 1e-6 * float(cot.abs().sum())


@pytest.mark.parametrize("B,L,D,A,F", DIN_SHAPES)
def test_din_head_fused_matches_plain(cuda, B, L, D, A, F):
    att, fc, hist, tgt, _ = _din_inputs(cuda, B, L, D, A, F, seed=B + L)
    weights = dh.din_head_weights(att, fc, D)
    before = cuda_dh.din_head_fused.launches
    got = dh.din_head_fwd(hist, tgt, weights)
    torch.cuda.synchronize()
    assert cuda_dh.din_head_fused.launches == before + 1
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, dh.din_head_fwd_plain(hist, tgt, weights), 1e-5)


@pytest.mark.parametrize("B,L,D,A,F", [s for s in DIN_SHAPES if s[0] < 20_000])
def test_din_head_fused_bwd_matches_plain(cuda, B, L, D, A, F):
    att, fc, hist, tgt, cot = _din_inputs(cuda, B, L, D, A, F, seed=B + D)
    weights = dh.din_head_weights(att, fc, D)
    before = cuda_dh.din_head_fused_bwd.launches
    got = dh.din_head_bwd(hist, tgt, weights, cot)
    torch.cuda.synchronize()
    assert cuda_dh.din_head_fused_bwd.launches == before + 3
    want = dh.din_head_bwd_plain(hist, tgt, weights, cot)
    assert len(got) == len(want) == 16
    for i, (gt, wt) in enumerate(zip(got, want)):
        assert gt.shape == wt.shape and gt.dtype == torch.float32
        if i == DB3:
            _close_db3(gt, wt, cot)
        else:
            _close(gt, wt, 1e-4)
    # the same gradients every run: the block slots are summed in a fixed order
    for a, b_ in zip(dh.din_head_bwd(hist, tgt, weights, cot), got):
        assert torch.equal(a, b_)


def test_din_head_autograd_on_the_card(cuda):
    """DinHead under autograd: one forward and three backward launches; the
    gradients of the MLPs' params (through the decomposition) and of the
    embeddings are those of the CPU plain versions."""
    att, fc, hist, tgt, cot = _din_inputs(cuda, 300, 10, 16, (32, 16, 1), (64, 32, 1), seed=3)

    def leaves(device):
        tree = [[{k: v.detach().to(device).requires_grad_(True) for k, v in layer.items()}
                 for layer in net] for net in (att, fc)]
        return tree, hist.detach().to(device).requires_grad_(True), \
            tgt.detach().to(device).requires_grad_(True)

    (a_card, f_card), h_card, t_card = leaves(cuda)
    before = cuda_dh.din_head_fused.launches, cuda_dh.din_head_fused_bwd.launches
    (dh.din_head(a_card, f_card, h_card, t_card) * cot).sum().backward()
    torch.cuda.synchronize()
    assert (cuda_dh.din_head_fused.launches, cuda_dh.din_head_fused_bwd.launches) == (
        before[0] + 1, before[1] + 3)
    (a_cpu, f_cpu), h_cpu, t_cpu = leaves("cpu")
    (dh.din_head(a_cpu, f_cpu, h_cpu, t_cpu) * cot.cpu()).sum().backward()
    _close_db3(a_card[2]["b"].grad.cpu(), a_cpu[2]["b"].grad, cot)
    pairs = [(h_card, h_cpu), (t_card, t_cpu)] + [
        (lc[k], lp[k]) for nc, npu in ((a_card, a_cpu), (f_card, f_cpu))
        for lc, lp in zip(nc, npu) for k in lc if lc is not a_card[2] or k != "b"]
    for got, want in pairs:
        _close(got.grad.cpu(), want.grad, 1e-4)


@pytest.mark.parametrize("B,L,D,A,F", DIN_SHAPES)
def test_din_attention_pool_matches_plain(cuda, B, L, D, A, F):
    """The kernel drops the last layer's bias, which cancels in the softmax; the
    plain version keeps it (a nonzero bias here), so they agree to rounding."""
    att, _, hist, tgt, _ = _din_inputs(cuda, B, L, D, A, F, seed=B * L)
    before = cuda_dinatt.din_attention_pool.launches
    got = dinatt.din_attention_pool(hist, tgt, att)
    torch.cuda.synchronize()
    assert cuda_dinatt.din_attention_pool.launches == before + 1
    assert got.shape == (B, D) and got.dtype == torch.float32
    _close(got, dinatt.din_attention_pool_plain(hist, tgt, att), 1e-5)


def test_din_launchers_check_their_inputs(cuda):
    att, fc, hist, tgt, cot = _din_inputs(cuda, 10, 10, 8, (12, 8, 1), (16, 8, 1), seed=0)
    weights = dh.din_head_weights(att, fc, 8)
    long_att, long_fc, long_hist, long_tgt, _ = _din_inputs(cuda, 4, 65, 8, (12, 8, 1),
                                                            (16, 8, 1), seed=1)
    odd_att, odd_fc, odd_hist, odd_tgt, _ = _din_inputs(cuda, 4, 5, 6, (12, 8, 1), (16, 8, 1),
                                                        seed=2)
    for args, err in [((hist.double(), tgt, weights), TypeError),
                      ((hist, tgt[:5].contiguous(), weights), ValueError),
                      ((hist.transpose(0, 1), tgt, weights), ValueError),
                      ((hist, tgt, weights[:13]), ValueError),
                      ((long_hist, long_tgt, dh.din_head_weights(long_att, long_fc, 8)), ValueError),
                      ((odd_hist, odd_tgt, dh.din_head_weights(odd_att, odd_fc, 6)), ValueError)]:
        with pytest.raises(err):
            cuda_dh.din_head_fused(*args)
    with pytest.raises(ValueError):
        cuda_dh.din_head_fused_bwd(hist, tgt, weights, cot[:5].contiguous())
    for args in [(long_hist, long_tgt, long_att), (odd_hist, odd_tgt, odd_att),
                 (hist, tgt, att[:2])]:
        with pytest.raises(ValueError):
            cuda_dinatt.din_attention_pool(*args)
    with pytest.raises(TypeError):
        cuda_dinatt.din_attention_pool(hist.double(), tgt, att)
