"""The CUDA kernels against their plain PyTorch versions, on the card: the
serving top-k kernels, the embedding gather and its backward, the fused MF
trainer, the fused LR trainers (wide and compact), the AFM attention pool
(forward and backward), the fused DIN head (forward and backward, float32 and
bfloat16), the DIN attention pool, and the row-sparse update's dedup and
row-wise AdaGrad (``train/sparse.py``). Every test here needs an NVIDIA GPU with
nvcc and skips elsewhere; run them on the card with

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
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import sparse_rows as cuda_sparse
from deeplearningrecommendationsystem_tpu_torch.ops.embedding import gather_rows
from deeplearningrecommendationsystem_tpu_torch.ops.linear import mlp_init
from deeplearningrecommendationsystem_tpu_torch.train import sparse

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
# rank-2 serving factors over the ml-100k catalog; then the split catalog's
# grid: one user, a few, a served batch of 32 and all ml-100k users, over a
# one-item catalog, one item short of a chunk, ml-100k's, and several slices a
# user (with k in {1, 10, 50, 128})
SHAPES = [(37, 301, 16), (1, 100, 64), (9, 128, 7), (70, 1000, 100), (943, 1682, 2)] + [
    (U, I, 64) for U in (1, 3, 32, 943) for I in (1, 127, 1682, 5000)]
KS = [1, 7, 10, 50, 128]


def _one_launch(name, *args, k):
    """The kernel's answer, after checking it took one launch, merge included."""
    before = getattr(cuda_topk, name).launches
    got = getattr(topk, name)(*args, k=k)
    torch.cuda.synchronize()
    assert getattr(cuda_topk, name).launches == before + 1
    return got


@pytest.mark.parametrize("U,I,D", SHAPES)
@pytest.mark.parametrize("k", KS)
def test_topk_serve_matmul_equals_plain(cuda, U, I, D, k):
    if k > I:
        pytest.skip("k exceeds the catalog")
    P, Q, seen = _inputs(cuda, U, I, D, seed=U + I + k)
    _assert_equal(_one_launch("topk_serve_matmul", P, Q, seen, k=k),
                  topk.topk_serve_matmul_plain(P, Q, seen, k=k))


@pytest.mark.parametrize("U,I,D", SHAPES)
@pytest.mark.parametrize("k", KS)
def test_topk_scores_equals_plain(cuda, U, I, D, k):
    if k > I:
        pytest.skip("k exceeds the catalog")
    P, Q, seen = _inputs(cuda, U, I, D, seed=U * I + k)
    scores = P @ Q.T
    _assert_equal(_one_launch("topk_scores", scores, seen, k=k),
                  topk.topk_scores_plain(scores, seen, k=k))


@pytest.mark.parametrize("U,I,k", [(4, 300, 10), (1, 1682, 50), (2, 5000, 50)])
@pytest.mark.parametrize("name", ["topk_serve_matmul", "topk_scores"])
def test_user_with_fewer_unseen_items_than_k(cuda, name, U, I, k):
    """User 0 keeps three unseen items, in different slices of the catalog."""
    P, Q, seen = _inputs(cuda, U, I, 8, seed=U + I)
    keep = [5, I * 7 // 15, I - 10]
    seen[0] = True
    seen[0, keep] = False
    args = (P, Q, seen) if name == "topk_serve_matmul" else (P @ Q.T, seen)
    vals, ids = getattr(topk, name)(*args, k=k)
    _assert_equal((vals, ids), getattr(topk, f"{name}_plain")(*args, k=k))
    assert sorted(ids[0, :3].tolist()) == keep
    assert ids[0, 3:].tolist() == [i for i in range(k + 1) if i != 5][:k - 3]
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


@pytest.mark.parametrize("name", ["topk_serve_matmul", "topk_scores"])
def test_equal_values_in_different_slices(cuda, name):
    """The best value sits at items scattered over every slice, and the rest tie
    at 0: the lowest indices win both ties, whichever slice finishes first."""
    U, I, D, k = 3, 5000, 8, 100
    best = [4999, 3001, 17, 2500, 1200, 4095, 256, 255]
    Q = torch.zeros((I, D), device=cuda)
    Q[best, 0] = 1.0
    P = torch.zeros((U, D), device=cuda)
    P[:, 0] = 7.0
    seen = torch.zeros((U, I), dtype=torch.bool, device=cuda)
    seen[2, 17] = True
    args = (P, Q, seen) if name == "topk_serve_matmul" else (P @ Q.T, seen)
    for _ in range(3):  # the blocks finish in another order each time
        vals, ids = getattr(topk, name)(*args, k=k)
        _assert_equal((vals, ids), getattr(topk, f"{name}_plain")(*args, k=k))
    rest = [i for i in range(I) if i not in best]
    assert ids[0].tolist() == sorted(best) + rest[:k - len(best)]
    assert ids[2, :7].tolist() == sorted(set(best) - {17})


@pytest.mark.parametrize("name", ["topk_serve_matmul", "topk_scores"])
def test_a_row_that_is_all_seen(cuda, name):
    P, Q, seen = _inputs(cuda, 3, 1682, 64, seed=5)
    seen[1] = True
    args = (P, Q, seen) if name == "topk_serve_matmul" else (P @ Q.T, seen)
    vals, ids = getattr(topk, name)(*args, k=50)
    _assert_equal((vals, ids), getattr(topk, f"{name}_plain")(*args, k=50))
    assert ids[1].tolist() == list(range(50)) and bool((vals[1] == -1e30).all())


@pytest.mark.parametrize("U,I,D", [(37, 5000, 64), (600, 20_000, 64), (943, 1682, 2)])
def test_topk_serve_matmul_keeps_float32_accuracy(cuda, U, I, D):
    """Normal inputs: the 3xTF32 scores within 1e-4 of each row's largest
    |score| of cuBLAS's float32 ones (chip_smoke.py's RTOL); each id carries its
    own score. (600, 20000) takes the 64-user tiles."""
    g = torch.Generator(device=cuda).manual_seed(U)
    P = torch.randn((U, D), generator=g, device=cuda)
    Q = torch.randn((I, D), generator=g, device=cuda)
    seen = torch.rand((U, I), generator=g, device=cuda) < 0.05
    vals, ids = topk.topk_serve_matmul(P, Q, seen, k=50)
    want_v, _ = topk.topk_serve_matmul_plain(P, Q, seen, k=50)
    scores = torch.where(seen, -1e30, P @ Q.T)
    tol = 1e-4 * scores.masked_fill(seen, 0).abs().amax(dim=1, keepdim=True)
    assert bool(((vals - want_v).abs() <= tol).all())
    assert bool(((torch.gather(scores, 1, ids.long()) - vals).abs() <= tol).all())
    assert bool((ids.sort(dim=1).values.diff(dim=1) > 0).all())  # no id repeats


def test_wide_tiles_equal_plain(cuda):
    P, Q, seen = _inputs(cuda, 600, 20_000, 64, seed=8)
    assert cuda_topk.matmul_plan(600, 20_000, 64, P.get_device())[0]  # the 64-user tiles
    _assert_equal(topk.topk_serve_matmul(P, Q, seen, k=128),
                  topk.topk_serve_matmul_plain(P, Q, seen, k=128))


def test_topk_runs_on_the_callers_stream(cuda):
    """A split launch on a side stream, with its own workspace, equals the
    default stream's answer."""
    P, Q, seen = _inputs(cuda, 32, 1682, 64, seed=12)
    want = topk.topk_serve_matmul_plain(P, Q, seen, k=50)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = [topk.topk_serve_matmul(P, Q, seen, k=50), topk.topk_scores(P @ Q.T, seen, k=50)]
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    for g_ in got:
        _assert_equal(g_, want)



def test_split_launches_from_two_threads_on_one_stream(cuda):
    """Two threads launch split top-k calls on the one default stream from an
    empty workspace cache, one of them at a larger catalog (more slices, longer
    lists), the other at more users (more counters), so each grows the
    stream's workspace: every answer equals the plain version's, so no launch
    finds counters that are not yet zero or reads another's lists."""
    import threading

    cases = [_inputs(cuda, 32, 1682, 64, seed=13), _inputs(cuda, 3, 50_000, 64, seed=14)]
    scores = [P @ Q.T for P, Q, _ in cases]
    wants = [(topk.topk_serve_matmul_plain(P, Q, s, k=50), topk.topk_scores_plain(S, s, k=50))
             for (P, Q, s), S in zip(cases, scores)]
    assert all(cuda_topk.matmul_plan(P.shape[0], Q.shape[0], 64, P.get_device())[2] > 1
               for P, Q, _ in cases)  # both calls split the catalog
    got = [[], []]
    torch.cuda.synchronize()
    cuda_topk._workspaces.clear()

    def run(j):
        (P, Q, s), S = cases[j], scores[j]
        for _ in range(50):
            got[j].append((topk.topk_serve_matmul(P, Q, s, k=50), topk.topk_scores(S, s, k=50)))

    threads = [threading.Thread(target=run, args=(j,)) for j in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    for j in range(2):
        assert len(got[j]) == 50
        for mm, sc in got[j]:
            _assert_equal(mm, wants[j][0])
            _assert_equal(sc, wants[j][1])


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

def _reorder(rows, ids, V, g):
    """Ids [B] of tables of V rows as ``rows`` says: "grouped" (as given),
    "shuffled" (a random permutation of the rows), "skewed" (a third of the
    rows on one id) or "out_of_range" (some ids below 0 or V and more)."""
    B = ids.shape[0]
    if rows == "shuffled":
        return ids[torch.randperm(B, generator=g, device=ids.device)].contiguous()
    ids = ids.clone()
    if rows == "skewed":
        ids[torch.rand(B, generator=g, device=ids.device) < 0.33] = V // 2
    elif rows == "out_of_range":
        bad = torch.randint(0, B, (max(1, B // 10),), generator=g, device=ids.device)
        ids[bad] = torch.tensor([-1, V, V + 5], device=ids.device, dtype=ids.dtype)[
            torch.arange(bad.shape[0], device=ids.device) % 3]
    return ids


def _mf_inputs(cuda, U, I, D, B, seed, rows="grouped"):
    g = torch.Generator(device=cuda).manual_seed(seed)
    uid = torch.sort(torch.randint(0, U, (B,), generator=g, device=cuda)).values.to(torch.int32)
    iid = torch.randint(0, I, (B,), generator=g, device=cuda).to(torch.int32)
    y = (torch.rand((B,), generator=g, device=cuda) < 0.3).float()
    pu = 0.1 * torch.randn((U, D), generator=g, device=cuda)
    pi = 0.1 * torch.randn((I, D), generator=g, device=cuda)
    return _reorder(rows, uid, U, g), _reorder(rows, iid, I, g), y, pu, pi


# float32: sums in another order, carried through Adam's normalised steps;
# bfloat16: a gradient row may round to the other bf16 neighbour
MF_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 2e-3)}  # (loss rtol, table atol)


# D 192 and 256 take the kernel's 8 columns a lane, D 512 its 16, odd D one column
# a load; the rows grouped by user, shuffled, with skewed ids (segments across
# many chunks) or with ids out of range
@pytest.mark.parametrize("U,I,D,B,rows", [
    (50, 81, 16, 300, "grouped"), (943, 1682, 64, 20_000, "grouped"), (7, 9, 100, 33, "grouped"),
    (50, 81, 192, 300, "grouped"), (60, 90, 256, 2_000, "grouped"), (30, 40, 512, 500, "grouped"),
    (943, 1682, 64, 20_000, "shuffled"), (943, 1682, 64, 20_000, "skewed"),
    (50, 81, 16, 3_000, "out_of_range"), (60, 90, 256, 2_000, "skewed"),
    (7, 9, 100, 33, "out_of_range"), (20, 30, 33, 700, "shuffled")])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_mf_fullbatch_train_matches_plain(cuda, U, I, D, B, rows, compute_dtype):
    args = _mf_inputs(cuda, U, I, D, B, seed=U + B, rows=rows)
    before = cuda_mfe.mf_fullbatch_train.launches
    pu, pi, losses = mfe.mf_fullbatch_train(*args, 6, 0.01, 1e-5, compute_dtype)
    torch.cuda.synchronize()
    assert cuda_mfe.mf_fullbatch_train.launches == before + 1  # one launch a call
    want_pu, want_pi, want_losses = mfe.mf_fullbatch_train_plain(*args, 6, 0.01, 1e-5,
                                                                 compute_dtype)
    rtol, atol = MF_TOL[compute_dtype]
    torch.testing.assert_close(losses, want_losses, rtol=rtol, atol=0)
    torch.testing.assert_close(pu, want_pu, rtol=0, atol=atol)
    torch.testing.assert_close(pi, want_pi, rtol=0, atol=atol)
    # the same bits every call: no atomics, every sum in a fixed order
    again = mfe.mf_fullbatch_train(*args, 6, 0.01, 1e-5, compute_dtype)
    assert all(torch.equal(a, b) for a, b in zip((pu, pi, losses), again))


def test_mf_fullbatch_train_int64_ids_and_no_epochs(cuda):
    uid, iid, y, pu0, pi0 = _mf_inputs(cuda, 50, 81, 64, 3_000, seed=4, rows="shuffled")
    got = mfe.mf_fullbatch_train(uid.long(), iid.long(), y, pu0, pi0, 3, 0.01, 1e-5, "float32")
    want = mfe.mf_fullbatch_train(uid, iid, y, pu0, pi0, 3, 0.01, 1e-5, "float32")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    pu, pi, losses = mfe.mf_fullbatch_train(uid, iid, y, pu0, pi0, 0, 0.01)
    assert torch.equal(pu, pu0) and torch.equal(pi, pi0) and losses.shape == (0,)


def test_mf_grid_too_large_raises(cuda, monkeypatch):
    """A grid that cannot be resident is refused by the cooperative launch: the
    launcher raises and launches nothing else."""
    args = _mf_inputs(cuda, 50, 81, 64, 3_000, seed=5)
    most = cuda_mfe._lib().mf_train_grid(64, 0)  # every block the card keeps resident
    monkeypatch.setattr(cuda_mfe, "_grid", lambda *a: most + 1)
    before = cuda_mfe.mf_fullbatch_train.launches
    with pytest.raises(RuntimeError, match="mf_fullbatch_train launch failed"):
        mfe.mf_fullbatch_train(*args, 2, 0.01, 1e-5, "float32")
    assert cuda_mfe.mf_fullbatch_train.launches == before
    monkeypatch.setattr(cuda_mfe, "_grid", lambda *a: most)  # the largest resident grid runs
    got = mfe.mf_fullbatch_train(*args, 2, 0.01, 1e-5, "float32")
    want = mfe.mf_fullbatch_train_plain(*args, 2, 0.01, 1e-5, "float32")
    torch.testing.assert_close(got[2], want[2], rtol=MF_TOL["float32"][0], atol=0)


def test_mf_launcher_checks_its_inputs(cuda):
    uid, iid, y, pu, pi = _mf_inputs(cuda, 5, 6, 8, 20, seed=0)
    bad = [
        ((uid.float(), iid, y, pu, pi), TypeError),
        ((uid, iid.long(), y, pu, pi), TypeError),  # ids of two dtypes
        ((uid, iid, y[:5], pu, pi), ValueError),
        ((uid, iid, y, pu, pi[:, :4].contiguous()), ValueError),
        ((uid, iid, y, torch.zeros((5, 513), device=cuda), torch.zeros((6, 513), device=cuda)),
         ValueError),  # D past 512, the widest the kernel takes
    ]
    for args, err in bad:
        with pytest.raises(err):
            cuda_mfe.mf_fullbatch_train(*args, 2, 0.01)
    with pytest.raises(ValueError):
        cuda_mfe.mf_fullbatch_train(uid, iid, y, pu, pi, 2, 0.01, compute_dtype="float16")


# ---- the fused LR trainers (csrc/lr_epoch.cu)

# losses rtol, weights atol: float32 sums in another order (per-block partials,
# segment sums) carried through Adam's normalised steps at lr 0.05
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
@pytest.mark.parametrize("rows", ["grouped", "shuffled", "skewed"])
def test_lr_fullbatch_train_compact_matches_plain(cuda, B, U, I, padded, rows):
    uid, iid, dense, y = _lr_inputs(cuda, B, U, I, 43, seed=B + 1)
    g_rows = torch.Generator(device=cuda).manual_seed(B + 7)
    uid, iid = _reorder(rows, uid, U, g_rows), _reorder(rows, iid, I, g_rows)
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
        assert cuda_lre.lr_fullbatch_train_compact.launches == before + 1  # one launch a call
        want_w, want_losses = lre.lr_fullbatch_train_compact_plain(*args)
        torch.testing.assert_close(losses, want_losses, rtol=LR_TOL[0], atol=0)
        torch.testing.assert_close(w, want_w, rtol=0, atol=LR_TOL[1])
        # the same bits every call: segment sums and block partials in a fixed order
        again = lre.lr_fullbatch_train_compact(*args)
        assert torch.equal(again[0], w) and torch.equal(again[1], losses)
        if padded:  # lanes no id matches keep their value
            assert not bool(w[0, U:u_pad].any()) and not bool(w[0, u_pad + i_pad + 44:].any())


def test_lr_compact_grid_too_large_raises(cuda, monkeypatch):
    """As for MF: a grid that cannot be resident raises, and nothing falls back."""
    uid, iid, dense, y = _lr_inputs(cuda, 500, 20, 30, 4, seed=3)
    w0 = torch.zeros((1, 20 + 30 + 4), device=cuda)
    most = cuda_lre._lib().lr_compact_grid(4)
    monkeypatch.setattr(cuda_lre, "_compact_grid", lambda *a: most + 1)
    before = cuda_lre.lr_fullbatch_train_compact.launches
    with pytest.raises(RuntimeError, match="lr_fullbatch_train_compact launch failed"):
        lre.lr_fullbatch_train_compact(uid, iid, dense, y, w0, 2, 0.05, 20, 30)
    assert cuda_lre.lr_fullbatch_train_compact.launches == before


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
# and at one catalog tile of 64 users, widths that need padding; then widths
# whose weights do not fit in shared memory beside a tile (the kernels read
# them from device memory), A past 128, and D past one patch of the
# backward's dW rows (D-panels): (128, 128), (256, 64), (64, 256), (256, 256),
# and the ragged (36, 20)
AFM_SHAPES = [(70, 32, 16), (5_003, 128, 64), (107_648, 128, 64), (301, 7, 5), (40, 64, 128),
              (2_001, 128, 128), (2_001, 256, 64), (1_003, 64, 256), (1_003, 256, 256),
              (503, 36, 20)]


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


@pytest.mark.parametrize("B,D,A", AFM_SHAPES)
def test_afm_attention_pool_repeats_bit_for_bit(cuda, B, D, A):
    """A fixed order of summation and no atomics: two launches, the same bits."""
    args = _afm_inputs(cuda, B, D, A, seed=B + 2 * D)[:4]
    assert torch.equal(afm.afm_attention_pool(*args), afm.afm_attention_pool(*args))


@pytest.mark.parametrize("buffer", [0, 1])
def test_afm_attention_pool_partial_last_tile(cuda, buffer):
    """The forward's persistent blocks (one an SM at the preset's widths) are
    two groups of warps, each with its own staging buffer; tile t goes to group
    t % 2. With 2 * SMs + buffer full 16-row tiles and 5 rows more, the partial
    last tile lands in the first group's buffer (buffer 0) or the second's."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    B = 16 * (2 * sms + buffer) + 5
    fields, w, b, h, _ = _afm_inputs(cuda, B, 128, 64, seed=buffer)
    _close(afm.afm_attention_pool(fields, w, b, h), afm.afm_attention_pool_plain(fields, w, b, h), 1e-5)


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
                      ((fields, torch.zeros((8, 257), device=cuda), torch.zeros(257, device=cuda),
                        torch.zeros((257, 1), device=cuda)), ValueError)]:  # A past 256
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


# the float32 forward only: the first fc width at its largest (K 2048 in the
# second fc product), the preset at the longest history, and an embedding too
# wide for the tensor-core forward's tiles at L 64 (its CUDA-core kernel, one
# launch)
DIN_F32_SHAPES = [(300, 10, 16, (32, 16, 1), (2048, 128, 1)),
                  (2_000, 64, 64, (128, 64, 1), (256, 128, 1)),
                  (20, 64, 512, (8, 4, 1), (8, 4, 1))]


def _fwd_launches(L, D, A, F) -> int:
    """Launches of one float32 forward: 2 on the tensor cores (attention stage,
    fc head), 1 where the widths take the CUDA-core kernel."""
    return 2 if cuda_dh._lib().din_head_fits(L, D, A[0], A[1], F[0], F[1]) & cuda_dh.TF32_FWD else 1


def _bwd_launches(L, D, A, F, dtype=torch.float32) -> int:
    """Launches of one backward without the forward's pooled rows: 5 where the
    widths take the split in that dtype (the pooled rows, fc head, attention
    unit, fc weight gradients, reduce), 3 where they take
    din_head_bwd_kernel<float> (float32 only: bf16 has the split alone)."""
    bit = cuda_dh.SPLIT_BF16 if dtype == torch.bfloat16 else cuda_dh.SPLIT_F32
    return 5 if cuda_dh._lib().din_head_fits(L, D, A[0], A[1], F[0], F[1]) & bit else 3


# the backward besides DIN_SHAPES: an embedding whose float32 backward keeps
# din_head_bwd_kernel<float> at L 64, and the preset at the longest history on
# the tensor cores
DIN_BWD_SHAPES = [(60, 64, 512, (8, 4, 1), (8, 4, 1)),
                  (2_000, 64, 64, (128, 64, 1), (256, 128, 1))]
# the widest fc the kernels take: din_head_bwd_fc_head_kernel's tile does not fit
# (the split's fc head streams: din_head_bwd_fc_stream_kernel), and the fc
# weight gradients stage a few rows (float32), or a window of columns (bf16), at
# a time
DIN_WIDE_FC_SHAPE = (300, 10, 64, (128, 64, 1), (2048, 2048, 1))


@pytest.mark.parametrize("B,L,D,A,F", DIN_SHAPES + DIN_F32_SHAPES)
def test_din_head_fused_matches_plain(cuda, B, L, D, A, F):
    att, fc, hist, tgt, _ = _din_inputs(cuda, B, L, D, A, F, seed=B + L)
    weights = dh.din_head_weights(att, fc, D)
    before = cuda_dh.din_head_fused.launches, cuda_dh.din_head_fused.launches_by_dtype["float32"]
    got = dh.din_head_fwd(hist, tgt, weights)
    torch.cuda.synchronize()
    n = _fwd_launches(L, D, A, F)
    assert (cuda_dh.din_head_fused.launches,
            cuda_dh.din_head_fused.launches_by_dtype["float32"]) == (before[0] + n, before[1] + n)
    assert n == 2 or D == 512  # the tensor cores take every shape but the widest
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got, dh.din_head_fwd_plain(hist, tgt, weights), 1e-5)
    assert torch.equal(dh.din_head_fwd(hist, tgt, weights), got)  # two launches repeat bit for bit


@pytest.mark.parametrize("B,L,D,A,F", [s for s in DIN_SHAPES if s[0] < 20_000] + DIN_BWD_SHAPES)
def test_din_head_fused_bwd_matches_plain(cuda, B, L, D, A, F):
    att, fc, hist, tgt, cot = _din_inputs(cuda, B, L, D, A, F, seed=B + D)
    weights = dh.din_head_weights(att, fc, D)
    before = cuda_dh.din_head_fused_bwd.launches
    got = dh.din_head_bwd(hist, tgt, weights, cot)
    torch.cuda.synchronize()
    assert cuda_dh.din_head_fused_bwd.launches == before + _bwd_launches(L, D, A, F)
    assert _bwd_launches(L, D, A, F) == (3 if D == 512 else 5)
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


def _kinked_rows(hist, tgt, weights, limit=1e-6):
    """[B] bool: rows with a relu input (z1, z2, and the fc head's before its
    relus) within ``limit`` of its layer's largest |value| from 0, in float64.
    There the mask, so the row's gradient, may follow the order of summation
    (chip_smoke.py's DIN_KINK rule)."""
    wh, wt, b1, w2, b2, w3, b3, u1p, u1t, c1, u2, c2, u3, c3 = (w.double() for w in weights)
    h, t = hist.double(), tgt.double()
    z1 = h @ wh + (t @ wt + b1)[:, None, :]
    z2 = torch.relu(z1) @ w2 + b2
    w = torch.softmax((torch.relu(z2) @ w3 + b3)[..., 0], dim=-1)
    y1 = torch.einsum("bl,bld->bd", w, h) @ u1p + t @ u1t + c1
    y2 = torch.relu(y1) @ u2 + c2
    near = torch.zeros(h.shape[0], dtype=torch.bool, device=h.device)
    for z in (z1, z2, y1, y2):
        z = z.abs().reshape(h.shape[0], -1)
        near |= z.amin(dim=1) <= limit * z.max()
    return near


def test_din_head_fused_bwd_at_the_widest_fc(cuda):
    """F (2048, 2048) in float32: the split's five launches (its fc head in
    din_head_bwd_fc_stream_kernel<float>, not din_head_bwd_kernel<float>) and
    the plain version's gradients on the rows none of whose 4,096 fc relu
    inputs lies at a kink; two launches repeat bit for bit."""
    B, L, D, A, F = DIN_WIDE_FC_SHAPE
    att, fc, hist, tgt, cot = _din_inputs(cuda, B, L, D, A, F, seed=B + D)
    weights = dh.din_head_weights(att, fc, D)
    keep = ~_kinked_rows(hist, tgt, weights)
    assert int(keep.sum()) > B // 2
    sub = (hist[keep].contiguous(), tgt[keep].contiguous(), weights, cot[keep].contiguous())
    before = cuda_dh.din_head_fused_bwd.launches
    got = dh.din_head_bwd(*sub)
    torch.cuda.synchronize()
    assert cuda_dh.din_head_fused_bwd.launches == before + _bwd_launches(L, D, A, F) == before + 5
    for i, (gt, wt) in enumerate(zip(got, dh.din_head_bwd_plain(*sub))):
        if i == DB3:
            _close_db3(gt, wt, sub[3])
        else:
            _close(gt, wt, 1e-4)
    assert all(torch.equal(a, b_) for a, b_ in zip(dh.din_head_bwd(*sub), got))


def test_din_head_autograd_on_the_card(cuda):
    """DinHead under autograd: two forward and four backward launches (the
    forward's pooled rows handed to the backward); the
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
        before[0] + 2, before[1] + 4)
    (a_cpu, f_cpu), h_cpu, t_cpu = leaves("cpu")
    (dh.din_head(a_cpu, f_cpu, h_cpu, t_cpu) * cot.cpu()).sum().backward()
    _close_db3(a_card[2]["b"].grad.cpu(), a_cpu[2]["b"].grad, cot)
    pairs = [(h_card, h_cpu), (t_card, t_cpu)] + [
        (lc[k], lp[k]) for nc, npu in ((a_card, a_cpu), (f_card, f_cpu))
        for lc, lp in zip(nc, npu) for k in lc if lc is not a_card[2] or k != "b"]
    for got, want in pairs:
        _close(got.grad.cpu(), want.grad, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [(256, 128, 1), (2048, 2048, 1)])
def test_din_head_backward_takes_the_forwards_pooled_rows(cuda, dtype, F):
    """The forward's pooled rows (``din_head_fused_pooled``: the float32
    attention stage's, or din_fwd_kernel<bf16>'s) are the bits the backward's
    own launch of that stage writes: handed to the backward they save its first
    launch and change no gradient's bits. The forward's logits are those of the
    forward that keeps no pooled rows, bit for bit, but in bf16 past the library's
    (kTensorPoolF1, kTensorPoolF2) (fc (2048, 2048) here), where the pooled rows'
    attention unit sums in k order on CUDA cores: there within the bf16
    forward's tolerance."""
    att, fc, hist, tgt, cot = _din_inputs(cuda, 5_003 if F[0] < 2048 else 300, 10, 64,
                                          (128, 64, 1), F, seed=1)
    weights = [w.to(dtype) for w in dh.din_head_weights(att, fc, 64)]
    hist, tgt, cot = hist.to(dtype), tgt.to(dtype), cot.to(dtype)
    out, pooled = cuda_dh.din_head_fused_pooled(hist, tgt, weights)
    assert pooled.shape == (hist.shape[0], 64) and pooled.dtype == torch.float32
    alone = cuda_dh.din_head_fused(hist, tgt, weights)
    if dtype == torch.bfloat16 and F[0] == 2048:
        _close(out.float(), alone.float(), DIN_BF16_RTOL["fwd"])
    else:
        assert torch.equal(out, alone)
    before = cuda_dh.din_head_fused_bwd.launches
    got = cuda_dh.din_head_fused_bwd(hist, tgt, weights, cot, pooled)
    torch.cuda.synchronize()
    assert cuda_dh.din_head_fused_bwd.launches == before + 4
    want = cuda_dh.din_head_fused_bwd(hist, tgt, weights, cot)
    assert cuda_dh.din_head_fused_bwd.launches == before + 9
    assert all(torch.equal(a, b_) for a, b_ in zip(got, want))


def test_din_head_cuda_core_forward_keeps_no_pooled_rows(cuda):
    """Where the float32 forward takes din_fwd_kernel<float> (D 512 at L 64) it
    returns no pooled rows, and its backward keeps din_head_bwd_kernel<float>."""
    att, fc, hist, tgt, cot = _din_inputs(cuda, 20, 64, 512, (8, 4, 1), (8, 4, 1), seed=2)
    assert cuda_dh.din_head_fused_pooled(hist, tgt, dh.din_head_weights(att, fc, 512))[1] is None
    assert _bwd_launches(64, 512, (8, 4, 1), (8, 4, 1)) == 3


def test_din_head_bf16_backward_takes_only_the_split(cuda):
    """At widths whose tiles fit the float32 backward's tile walk but not the
    bf16 split (the fits bits FWD | BWD: a short history at D 1612), the float32
    backward launches din_head_bwd_kernel<float> and matches its plain version;
    the bf16 backward raises before any launch, and kernel_route refuses the
    widths (no window pool tile either)."""
    B, L, D, A, F = 40, 4, 1612, (12, 8, 1), (20, 12, 1)
    assert cuda_dh._lib().din_head_fits(L, D, A[0], A[1], F[0], F[1]) == cuda_dh.FWD | cuda_dh.BWD
    att, fc, hist, tgt, cot = _din_inputs(cuda, B, L, D, A, F, seed=7)
    assert not dh.kernel_route(att, fc, L, D)
    weights = dh.din_head_weights(att, fc, D)
    before = cuda_dh.din_head_fused_bwd.launches
    got = dh.din_head_bwd(hist, tgt, weights, cot)
    torch.cuda.synchronize()
    assert cuda_dh.din_head_fused_bwd.launches == before + 3
    for i, (gt, wt) in enumerate(zip(got, dh.din_head_bwd_plain(hist, tgt, weights, cot))):
        if i == DB3:
            _close_db3(gt, wt, cot)
        else:
            _close(gt, wt, 1e-4)
    with pytest.raises(RuntimeError, match="SPLIT_BF16"):
        dh.din_head_bwd(*_bf16(hist, tgt), _bf16(*weights), cot.bfloat16())
    assert cuda_dh.din_head_fused_bwd.launches == before + 3


def _bf16(*tensors):
    return [t.to(torch.bfloat16) for t in tensors]


# bf16 kernel against the bf16 plain version: both round the same operands to
# bf16, but their float32 sums run in another order, so a rounded value can
# land on the other bf16 neighbour: normwise 8e-3 forward (one bf16 ulp of the
# largest logit is up to 2^-7 of it) and 1e-2 backward (the JAX kernel's own
# bf16 test allows 2e-2 against float32)
DIN_BF16_RTOL = {"fwd": 8e-3, "bwd": 1e-2}


@pytest.mark.parametrize("B,L,D,A,F", DIN_SHAPES)
def test_din_head_fused_bf16_matches_plain(cuda, B, L, D, A, F):
    att, fc, hist, tgt, _ = _din_inputs(cuda, B, L, D, A, F, seed=B + L)
    weights = _bf16(*dh.din_head_weights(att, fc, D))
    hist, tgt = _bf16(hist, tgt)
    got = dh.din_head_fwd(hist, tgt, weights)
    torch.cuda.synchronize()
    want = dh.din_head_fwd_plain(hist, tgt, weights)
    assert got.shape == (B,) and got.dtype == want.dtype == torch.bfloat16
    _close(got.float(), want.float(), DIN_BF16_RTOL["fwd"])


@pytest.mark.parametrize("B,L,D,A,F", [s for s in DIN_SHAPES if s[0] < 20_000] + [DIN_WIDE_FC_SHAPE])
def test_din_head_fused_bwd_bf16_matches_plain(cuda, B, L, D, A, F):
    att, fc, hist, tgt, cot = _din_inputs(cuda, B, L, D, A, F, seed=B + D)
    weights = _bf16(*dh.din_head_weights(att, fc, D))
    hist, tgt, cot = _bf16(hist, tgt, cot)
    before = cuda_dh.din_head_fused_bwd.launches, dict(cuda_dh.din_head_fused_bwd.launches_by_dtype)
    got = dh.din_head_bwd(hist, tgt, weights, cot)
    torch.cuda.synchronize()
    n = _bwd_launches(L, D, A, F, torch.bfloat16)
    assert n == 5  # the split at every shape here
    assert cuda_dh.din_head_fused_bwd.launches == before[0] + n
    assert cuda_dh.din_head_fused_bwd.launches_by_dtype == {
        "float32": before[1]["float32"], "bfloat16": before[1]["bfloat16"] + n}
    want = dh.din_head_bwd_plain(hist, tgt, weights, cot)
    for i, (gt, wt) in enumerate(zip(got, want)):
        assert gt.shape == wt.shape and gt.dtype == torch.float32
        if i == DB3:
            _close_db3(gt, wt, cot.float())
        else:
            _close(gt, wt, DIN_BF16_RTOL["bwd"])


def test_din_head_fit_mirror_matches_the_library(cuda):
    """``fits`` (the layouts' shared-memory sums in Python, which
    ``kernel_route`` decides from on any device) says what ``din_head_fits``
    of the library says, over a grid of widths: L 1 to 64, D past every fit
    at L 64, narrow, preset and wide attention and fc nets."""
    lib = cuda_dh._lib()
    for L in (1, 7, 10, 33, 64):
        for D in (4, 8, 64, 128, 256, 352, 360, 364, 512, 640, 644, 1024, 2048):
            for A in ((12, 8), (128, 64), (256, 256)):
                for F in ((20, 12), (256, 128), (2048, 128), (2048, 2048)):
                    assert cuda_dh.fits(L, D, *A, *F) == lib.din_head_fits(L, D, *A, *F), (L, D, A, F)
    assert cuda_dh.fits(10, 6, 128, 64, 256, 128) == lib.din_head_fits(10, 6, 128, 64, 256, 128) == 0
    split = cuda_dh.SPLIT_F32 | cuda_dh.SPLIT_BF16
    for F in ((256, 128), (2048, 2048)):  # the preset and the widest fc take the split in both dtypes
        assert lib.din_head_fits(10, 64, 128, 64, *F) & split == split
    assert cuda_dh.fits(65, 64, 128, 64, 256, 128) == lib.din_head_fits(65, 64, 128, 64, 256, 128) == 0


# (L, D, whether every launch fits) at the preset's nets: the widest D whose
# tiles all fit at L 64, the next width (the window pool's tile no longer
# fits), and one past every tile of the head
DIN_FIT_EDGES = [(64, 360, True), (64, 364, False), (64, 1024, False)]


@pytest.mark.parametrize("L,D,fit", DIN_FIT_EDGES)
def test_din_launches_fit_where_the_route_says(cuda, L, D, fit):
    """Where ``kernel_route`` takes a shape, the head (both dtypes, both ways)
    and the window pool launch; past it some launch cannot fit and raises."""
    att, fc, hist, tgt, cot = _din_inputs(cuda, 20, L, D, (128, 64, 1), (256, 128, 1), seed=D)
    assert dh.kernel_route(att, fc, L, D) is fit
    weights = dh.din_head_weights(att, fc, D)
    calls = [lambda: dinatt.din_attention_pool(hist, tgt, att)]
    for dtype in (torch.float32, torch.bfloat16):
        w = [x.to(dtype) for x in weights]
        h, t = hist.to(dtype), tgt.to(dtype)
        calls += [lambda h=h, t=t, w=w: dh.din_head_fwd(h, t, w),
                  lambda h=h, t=t, w=w: dh.din_head_bwd(h, t, w, cot)]
    raised = 0
    for call in calls:
        try:
            call()
            torch.cuda.synchronize()
        except RuntimeError:
            raised += 1
    assert (raised == 0) is fit


def test_din_head_launcher_refuses_mixed_dtypes(cuda):
    att, fc, hist, tgt, cot = _din_inputs(cuda, 10, 10, 8, (12, 8, 1), (16, 8, 1), seed=0)
    weights = dh.din_head_weights(att, fc, 8)
    mixes = [(hist.bfloat16(), tgt, weights), (hist, tgt.bfloat16(), weights),
             (hist.bfloat16(), tgt.bfloat16(), weights),
             (hist, tgt, weights[:5] + (weights[5].bfloat16(),) + weights[6:])]
    for args in mixes:
        with pytest.raises(TypeError):
            cuda_dh.din_head_fused(*args)
        with pytest.raises(TypeError):
            cuda_dh.din_head_fused_bwd(*args, cot)


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


@pytest.mark.parametrize("B,L,D,A,F", DIN_SHAPES + [(333, 64, 16, (256, 8, 1), (16, 8, 1))])
def test_din_attention_pool_repeats_bit_for_bit(cuda, B, L, D, A, F):
    """A fixed order of summation and no atomics: two launches, the same bits."""
    att, _, hist, tgt, _ = _din_inputs(cuda, B, L, D, A, F, seed=B + L + D)
    assert torch.equal(dinatt.din_attention_pool(hist, tgt, att), dinatt.din_attention_pool(hist, tgt, att))


# (B, L, D, (A1, A2, 1)): the longest history with an A1 of four 64-column
# panels; the preset's widths with both layers in several panels (A2 128); and
# weights too large for shared memory beside a tile (read from device memory)
DIN_POOL_PANEL_SHAPES = [(333, 64, 16, (256, 8, 1)), (257, 64, 64, (256, 128, 1)),
                         (50, 3, 256, (256, 256, 1))]


@pytest.mark.parametrize("B,L,D,A", DIN_POOL_PANEL_SHAPES)
def test_din_attention_pool_column_panels(cuda, B, L, D, A):
    att, _, hist, tgt, _ = _din_inputs(cuda, B, L, D, A, (16, 8, 1), seed=B)
    got = dinatt.din_attention_pool(hist, tgt, att)
    torch.cuda.synchronize()
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


# (attention units, fc units, L): nets of one and three hidden layers, and a
# history past the kernels' 64, which DIN sends to the composition
DIN_COMPOSITION_SHAPES = [((64, 1), (32, 16, 1), 10), ((32, 16, 1), (200, 80, 40, 1), 10),
                          ((32, 16, 1), (64, 32, 1), 80)]


@pytest.mark.parametrize("att_units,fc_units,L", DIN_COMPOSITION_SHAPES)
def test_din_composition_route_launches_no_din_kernel(cuda, att_units, fc_units, L):
    """DIN at shapes ``kernel_route`` refuses: logits, gradients and the window
    scorer on the card equal the CPU's (the same plain torch), and no DIN
    kernel launches."""
    from deeplearningrecommendationsystem_tpu_torch.models import DIN, ServingContext

    kw = dict(embed_size=16, attention_units=att_units, fc_units=fc_units)
    cpu = DIN(200, **kw, generator=torch.Generator().manual_seed(0), device="cpu")
    card = DIN(200, **kw, device="cuda")
    card.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(1)
    hist, target = torch.randint(0, 200, (300, L), generator=gen), torch.randint(0, 200, (300,), generator=gen)
    counters = (cuda_dh.din_head_fused, cuda_dh.din_head_fused_bwd, cuda_dinatt.din_attention_pool)
    before = [c.launches for c in counters]
    got = card((hist.to(cuda), target.to(cuda)))
    got.square().sum().backward()
    ctx = ServingContext(torch.zeros((37, 1)), torch.zeros((200, 1)), history=hist[:37].to(cuda))
    with torch.no_grad():
        scores = card.score_catalog(ctx)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == before
    want = cpu((hist, target))
    want.square().sum().backward()
    _close(got.detach().cpu(), want.detach(), 1e-5)
    last_bias = f"att.{len(att_units) - 1}.b"  # d b = sum of ds: 0 but for rounding, as d b3 above
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        if name == last_bias:
            _close_db3(a.grad.cpu(), b.grad, 2 * want.detach())
        else:
            _close(a.grad.cpu(), b.grad, 1e-4)
    with torch.no_grad():
        want_scores = cpu.score_catalog(ServingContext(torch.zeros((37, 1)), torch.zeros((200, 1)),
                                                       history=hist[:37]))
    _close(scores.cpu(), want_scores, 1e-5)


# ---- the row-sparse update: the dedup's segment sums and row-wise AdaGrad

SPARSE_V, SPARSE_B, SPARSE_LR = 1000, 4096, 0.05
# how the batch's ids are drawn: repeating (a tenth of the rows); one id taking
# half the batch (a long run, read ahead through L2); a tenth of them the
# sentinel V (another rank's ids on an EP mesh); every id the sentinel (every
# slot after the first is padding, and the update changes nothing); row V - 1
# among the ids, and kept out of them
SPARSE_IDS = ["repeated", "half_one_id", "sentinel", "all_sentinel", "last_row", "no_last_row"]


def _sparse_ids(pattern, id_dtype, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    V, B = SPARSE_V, SPARSE_B
    ids = torch.randint(0, V - 1, (B,), generator=g, device=cuda)  # row V - 1 left out
    if pattern == "repeated":
        ids = ids % (V // 10)
    elif pattern == "half_one_id":
        ids[torch.randperm(B, generator=g, device=cuda)[: B // 2]] = 7
    elif pattern == "sentinel":
        ids[::10] = V
    elif pattern == "all_sentinel":
        ids.fill_(V)
    elif pattern == "last_row":
        ids[::3] = V - 1
    return ids.to(id_dtype)


def _sparse_step(pattern, id_dtype, D, cuda, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed + D)
    ids = _sparse_ids(pattern, id_dtype, cuda, seed)
    grads = torch.randn((SPARSE_B, D), generator=g, device=cuda)
    table = torch.randn((SPARSE_V, D), generator=g, device=cuda)
    accum = torch.rand(SPARSE_V, generator=g, device=cuda)
    return ids, grads, table, accum


def _adagrad(fn, table0, accum0, uids, ugrads):
    table, state = table0.clone(), sparse.RowwiseAdagradState(accum=accum0.clone())
    fn(table, state, uids, ugrads, SPARSE_LR)
    torch.cuda.synchronize()
    return table, state.accum


def _within_ulps(got, want, step):
    """Within 4 float32 ulps of the value and of the step taken: the mean
    square sums in another order than torch.mean's, so the accumulator, and
    through it the step, may differ in the last bits."""
    return bool(((got - want).abs() <= 4 * 2.0 ** -24 * (want.abs() + step.abs())).all())


# the widths the sparse models use, and a bias table's and an odd one (loads of
# one and of two floats)
@pytest.mark.parametrize("D", [1, 6, 16, 64, 128, 256])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("pattern", SPARSE_IDS)
def test_sparse_row_update_matches_plain(cuda, pattern, id_dtype, D):
    """The dedup kernel is its plain version (index_put_ on the card) bit for
    bit; AdaGrad's table and accumulator within a few ulps of the plain
    update's, every row no real slot names keeping its bits; each repeats its
    bits, the dedup in two launches a call (long runs, short runs; one for
    rows of one column, summed in the order of index_put_'s stride-1
    kernel), AdaGrad in one."""
    ids, grads, table0, accum0 = _sparse_step(pattern, id_dtype, D, cuda)
    before = cuda_sparse.dedup_rows.launches, cuda_sparse.rowwise_adagrad.launches
    uids, ugrads = sparse.dedup_rows(ids, grads, SPARSE_V)
    torch.cuda.synchronize()
    assert cuda_sparse.dedup_rows.launches == before[0] + (1 if D == 1 else 2)
    want = sparse.dedup_rows_plain(ids, grads, SPARSE_V)
    assert uids.dtype == want[0].dtype == id_dtype
    assert torch.equal(uids, want[0]) and torch.equal(ugrads, want[1])
    again = sparse.dedup_rows(ids, grads, SPARSE_V)
    assert torch.equal(again[0], uids) and torch.equal(again[1], ugrads)

    table, accum = _adagrad(sparse.rowwise_adagrad, table0, accum0, uids, ugrads)
    assert cuda_sparse.rowwise_adagrad.launches == before[1] + 1
    want_table, want_accum = _adagrad(sparse.rowwise_adagrad_plain, table0, accum0, uids, ugrads)
    assert _within_ulps(table, want_table, want_table - table0)
    assert _within_ulps(accum, want_accum, want_accum - accum0)
    touched = torch.zeros(SPARSE_V, dtype=torch.bool, device=cuda)
    touched[uids[uids < SPARSE_V].long()] = True
    assert torch.equal(table[~touched], table0[~touched])
    assert torch.equal(accum[~touched], accum0[~touched])
    assert bool((table[touched] != table0[touched]).any(dim=1).all())
    assert bool(touched[SPARSE_V - 1]) == (pattern == "last_row")
    if pattern == "all_sentinel":
        assert not touched.any() and torch.equal(table, table0)
    again = _adagrad(sparse.rowwise_adagrad, table0, accum0, uids, ugrads)
    assert torch.equal(again[0], table) and torch.equal(again[1], accum)


@pytest.mark.parametrize("name", ["rowwise_adagrad", "lazy_adam"])
def test_sparse_table_update_on_the_card(cuda, monkeypatch, name):
    """Three steps of ``sparse_table_update`` on the kernels against the same
    steps on the plain versions, on the card: lazy Adam (the kernel's dedup,
    its plain update) bit for bit, row-wise AdaGrad within a few ulps."""
    steps = [_sparse_step("sentinel", torch.int64, 64, cuda, seed) for seed in range(3)]
    table0 = steps[0][2]

    def run(on_kernels):
        """The table and state after the steps, and each one's sum over the
        steps of |value| + |change|: what a few ulps a step add up to."""
        monkeypatch.setattr(sparse, "_on_kernels", on_kernels)
        table = table0.clone()
        state = (sparse.RowwiseAdagradState.init(SPARSE_V, device=cuda) if name == "rowwise_adagrad"
                 else sparse.LazyAdamState.init(SPARSE_V, 64, device=cuda))
        leaves = (table, state.accum) if name == "rowwise_adagrad" else (table,)
        scale = [torch.zeros_like(t) for t in leaves]
        for ids, grads, _, _ in steps:
            before = [t.clone() for t in leaves]
            sparse.sparse_table_update(table, state, ids, grads, SPARSE_LR)
            for s, b, a in zip(scale, before, leaves):
                s += a.abs() + (a - b).abs()
        torch.cuda.synchronize()
        return table, state, scale

    on_kernels = sparse._on_kernels
    before = cuda_sparse.dedup_rows.launches
    table, state, _ = run(on_kernels)
    assert cuda_sparse.dedup_rows.launches == before + 6
    want_table, want_state, scale = run(lambda *a: False)
    if name == "lazy_adam":
        assert torch.equal(table, want_table) and torch.equal(state.mv, want_state.mv)
    else:
        # 4 ulps a step of each step's value and change, as a single step is held
        assert bool(((table - want_table).abs() <= 4 * 2.0 ** -24 * scale[0]).all())
        assert bool(((state.accum - want_state.accum).abs() <= 4 * 2.0 ** -24 * scale[1]).all())


@pytest.mark.parametrize("B", [0, 1, 2, 3])
def test_sparse_row_update_of_a_few_ids(cuda, B):
    """An empty batch launches nothing and changes nothing; one, two and three
    ids (one repeated) are the plain versions' as above."""
    before = cuda_sparse.dedup_rows.launches, cuda_sparse.rowwise_adagrad.launches
    ids = torch.tensor([5, 2, 5][:B], dtype=torch.int64, device=cuda)
    grads = torch.randn((B, 16), device=cuda)
    uids, ugrads = sparse.dedup_rows(ids, grads, SPARSE_V)
    want = sparse.dedup_rows_plain(ids, grads, SPARSE_V)
    assert uids.shape == (B,) and ugrads.shape == (B, 16)
    assert torch.equal(uids, want[0]) and torch.equal(ugrads, want[1])
    table0 = torch.randn((SPARSE_V, 16), device=cuda)
    accum0 = torch.rand(SPARSE_V, device=cuda)
    table, accum = _adagrad(sparse.rowwise_adagrad, table0, accum0, uids, ugrads)
    want_table, want_accum = _adagrad(sparse.rowwise_adagrad_plain, table0, accum0, uids, ugrads)
    assert _within_ulps(table, want_table, want_table - table0)
    assert _within_ulps(accum, want_accum, want_accum - accum0)
    moved = (table != table0).any(dim=1).nonzero().flatten().tolist()
    assert moved == sorted(set(ids.tolist()))
    launched = (2, 1) if B else (0, 0)
    assert (cuda_sparse.dedup_rows.launches - before[0],
            cuda_sparse.rowwise_adagrad.launches - before[1]) == launched


def test_sparse_rows_launchers_check_their_inputs(cuda):
    ids = torch.zeros(8, dtype=torch.int64, device=cuda)
    grads, table = torch.zeros((8, 16), device=cuda), torch.zeros((SPARSE_V, 16), device=cuda)
    accum = torch.zeros(SPARSE_V, device=cuda)
    with pytest.raises(TypeError):
        cuda_sparse.dedup_rows(ids, grads.bfloat16(), SPARSE_V)
    with pytest.raises(TypeError):
        cuda_sparse.dedup_rows(ids.float(), grads, SPARSE_V)
    with pytest.raises(ValueError, match="differ in rows"):
        cuda_sparse.dedup_rows(ids[:4], grads, SPARSE_V)
    with pytest.raises(ValueError, match="vocab"):
        cuda_sparse.dedup_rows(ids, grads, 2**31 - 1)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_sparse.dedup_rows(ids, grads.t().contiguous().t(), SPARSE_V)
    with pytest.raises(ValueError, match="disagree"):
        cuda_sparse.rowwise_adagrad(table, accum[:-1], ids, grads, SPARSE_LR, 1e-10)
    with pytest.raises(ValueError, match="disagree"):
        cuda_sparse.rowwise_adagrad(table, accum, ids, grads[:, :8].contiguous(), SPARSE_LR, 1e-10)
    with pytest.raises(TypeError):
        cuda_sparse.rowwise_adagrad(table.double(), accum, ids, grads, SPARSE_LR, 1e-10)
