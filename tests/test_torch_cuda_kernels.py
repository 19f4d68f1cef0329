"""The serving top-k CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs an NVIDIA GPU with nvcc and skips elsewhere; run
them on the card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py tests/test_torch_isolation.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX, which the card's
machine need not have; this file imports neither JAX nor the JAX package.)

Integer-valued inputs make every score exact, so kernel and plain version must
agree bit for bit, ties and the slots past a user's unseen items included.
"""

import pytest
import torch

from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as cuda_topk

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
