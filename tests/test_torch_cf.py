"""The port's classic CF (``cf/neighborhood.py``, ``cf/gdcf.py``, ``cli/cf.py``)
against the JAX package's, on the CPU (``topk_scores``' plain version).

UserCF's and ItemCF's predictions are sums of the same few similarities, so
many items tie exactly, and both packages put the lower index first; near
ties, whose float32 sums round differently in the two packages, may swap. So
the lists are compared where the scores decide them (the JAX function's
scores, recomputed by its own ops): where a user's k-th and (k+1)-th scores
lie further apart than 1e-5 of the largest |score|, the same items are
recommended, and where a position's score lies that far from both of its
neighbours' in the list, the same item stands there. ``cf_eval`` is the
reference's accumulation, exactly, on equal lists.

GDCF from the JAX run's initial ``P``, ``Q`` (``init_factors`` replaced by
``jax.random.uniform``'s draws): losses rtol 1e-5, the final scores atol 1e-4,
and each iteration's list held as above against its pre-update logits
recomputed in float64 from the same start (torch's Adam in float64).

``cli/cf.py`` runs each algorithm on the synthetic fixture's ``ua`` and
``u1`` folds with ``--device cpu --json``.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.cf import gdcf_train as jax_gdcf_train
from deeplearningrecommendationsystem_tpu.cf import neighborhood as jax_cf
from deeplearningrecommendationsystem_tpu_torch.cf import (
    cf_eval,
    gdcf_train,
    item_cf_recommend,
    load_base_test,
    user_cf_recommend,
)
from deeplearningrecommendationsystem_tpu_torch.cf import gdcf
from deeplearningrecommendationsystem_tpu_torch.cli import cf as cf_cli
from deeplearningrecommendationsystem_tpu_torch.data import write_ml100k_format

U, I, TOP_N, K = 120, 200, 20, 10
REL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test (see tests/test_torch_cli_run.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _matrix(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((U, I)) < rng.uniform(0.02, 0.2, (U, 1))).astype(np.float32)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _jax_scores(m, user_based, k=K):
    """The masked predictions the JAX function ranks, by its own ops, jitted
    as it is (eager ops break some exact neighbour ties otherwise)."""
    sim = jax_cf._cosine(m if user_based else m.T)
    sim = sim.at[jnp.diag_indices(sim.shape[0])].set(jax_cf.NEG_INF)
    w, idx = jax.lax.top_k(sim, k)
    if user_based:
        pred, denom = jnp.einsum("uk,uki->ui", w, m[idx]), jnp.sum(w, axis=1, keepdims=True)
    else:
        pred, denom = jnp.einsum("ik,uik->ui", w, m[:, idx]), jnp.sum(w, axis=1)
    pred = jnp.where(denom != 0, pred / jnp.where(denom != 0, denom, 1.0), 0.0)
    return jnp.where(m > 0, jax_cf.NEG_INF, pred)


def assert_lists_agree(got, want, scores, min_decided=0.5):
    """``got`` and ``want`` [U, n] agree wherever ``scores`` [U, I] decide them."""
    n = want.shape[1]
    finite = scores[scores > -1e29]
    tol = REL * np.abs(finite).max()
    ranked = -np.sort(-scores, axis=1)[:, : n + 1]  # each row's n + 1 best
    np.testing.assert_allclose(np.take_along_axis(scores, want, 1), ranked[:, :n], rtol=0,
                               atol=tol)  # ``want`` is the top n of ``scores``
    decided = ranked[:, n - 1] - ranked[:, n] > tol
    assert decided.mean() >= min_decided, decided.mean()
    for u in np.nonzero(decided)[0]:
        assert set(got[u].tolist()) == set(want[u].tolist()), u
    gaps = np.abs(np.diff(ranked, axis=1)) > tol  # [U, n]: position j apart from j + 1
    isolated = gaps.copy()
    isolated[:, 1:] &= gaps[:, :-1]
    isolated[:, 0] = gaps[:, 0]
    assert isolated.mean() >= min_decided / 2
    np.testing.assert_array_equal(got[isolated], want[isolated])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("algo", ["usercf", "itemcf"])
def test_neighbourhood_cf_matches_jax(algo, seed):
    m = _matrix(seed)
    port_fn, jax_fn = {"usercf": (user_cf_recommend, jax_cf.user_cf_recommend),
                       "itemcf": (item_cf_recommend, jax_cf.item_cf_recommend)}[algo]
    got = port_fn(m, k_neighbors=K, top_n=TOP_N, device="cpu")
    assert got.shape == (U, TOP_N) and got.dtype == torch.int32
    got = got.numpy()
    want = np.asarray(jax_fn(jnp.asarray(m), k_neighbors=K, top_n=TOP_N))
    assert_lists_agree(got, want, np.asarray(_jax_scores(jnp.asarray(m), algo == "usercf")))
    assert not np.take_along_axis(m, got.astype(np.int64), 1).any()  # unrated items only
    # cf_eval: the reference's accumulation, exactly as the JAX package's
    tests = [list(np.nonzero(row)[0][:3]) for row in _matrix(seed + 10)]
    assert cf_eval(got, tests) == jax_cf.cf_eval(got, tests)
    assert cf_eval(want, tests) == jax_cf.cf_eval(want, tests)


def test_cf_eval_counts():
    rec = np.array([[1, 2, 3, 4], [5, 6, 7, 8]])
    recall, precision, f1 = cf_eval(rec, [[1, 9], []])
    assert recall == 0.25 and precision == 0.125
    assert f1 == pytest.approx(2 * 0.25 * 0.125 / 0.375)
    assert cf_eval(rec, [[], []]) == (0.0, 0.0, 0.0)


def _jax_factors(seed, U_, I_, d):
    kp, kq = jax.random.split(jax.random.PRNGKey(seed))
    return np.asarray(jax.random.uniform(kp, (U_, d))), np.asarray(jax.random.uniform(kq, (d, I_)))


def _float64_logits(m, P, Q, lr, iterations):
    """Each iteration's pre-update logits, the same run in float64."""
    P = torch.tensor(P, dtype=torch.float64, requires_grad=True)
    Q = torch.tensor(Q, dtype=torch.float64, requires_grad=True)
    z = torch.tensor(m, dtype=torch.float64)
    opt = torch.optim.Adam([P, Q], lr=lr)
    out = []
    for _ in range(iterations):
        opt.zero_grad()
        logits = P @ Q
        gdcf.sigmoid_bce(logits, z).mean().backward()
        opt.step()
        out.append(logits.detach().numpy())
    return out


@pytest.mark.parametrize("exclude_rated", [False, True])
def test_gdcf_matches_jax(monkeypatch, exclude_rated):
    m = (np.random.default_rng(3).random((60, 90)) < 0.1).astype(np.float32)
    d, iters, k = 16, 10, 20
    P, Q = _jax_factors(0, 60, 90, d)
    monkeypatch.setattr(gdcf, "init_factors",
                        lambda seed, U_, I_, d_: (torch.from_numpy(P.copy()),
                                                  torch.from_numpy(Q.copy())))
    want, want_scores = jax_gdcf_train(jnp.asarray(m), embedding_size=d, iterations=iters,
                                       top_k=k, exclude_rated=exclude_rated)
    got, scores = gdcf_train(m, embedding_size=d, iterations=iters, top_k=k,
                             exclude_rated=exclude_rated, device="cpu")
    assert got["loss"].shape == (iters,) and got["rec"].shape == (iters, 60, k)
    np.testing.assert_allclose(got["loss"].numpy(), np.asarray(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=0, atol=1e-4)
    for it, logits in enumerate(_float64_logits(m, P, Q, 0.01, iters)):
        if exclude_rated:
            logits = np.where(m > 0, -1e30, logits)
        assert_lists_agree(got["rec"][it].numpy(), np.asarray(want["rec"][it]), logits,
                           min_decided=0.9)


def test_init_factors_are_seeded_uniform():
    P, Q = gdcf.init_factors(4, 5, 7, 3)
    assert P.shape == (5, 3) and Q.shape == (3, 7) and P.dtype == torch.float32
    assert 0 <= float(P.min()) and float(Q.max()) < 1
    torch.testing.assert_close(gdcf.init_factors(4, 5, 7, 3)[0], P, rtol=0, atol=0)


@pytest.fixture(scope="module")
def folds_dir(tmp_path_factory):
    return write_ml100k_format(str(tmp_path_factory.mktemp("mlcf")), seed=5, num_users=60,
                               num_items=300, num_ratings=3000)


def test_fixture_folds(folds_dir):
    m, tests = load_base_test(folds_dir, "ua")
    assert m.shape == (943, 1682) and m.dtype == np.float32
    assert [len(t) for t in tests[:60]] == [10] * 60 and not any(tests[60:])
    data = np.loadtxt(f"{folds_dir}/u.data", dtype=np.int64)
    for fold in ("ua", "u1"):
        base = np.loadtxt(f"{folds_dir}/{fold}.base", dtype=np.int64)
        test = np.loadtxt(f"{folds_dir}/{fold}.test", dtype=np.int64)
        pairs = {tuple(r[:2]) for r in base} | {tuple(r[:2]) for r in test}
        assert len(base) + len(test) == len(data) == len(pairs)  # disjoint, covering
    assert len(np.loadtxt(f"{folds_dir}/u1.test")) == 600


@pytest.mark.parametrize("algo", ["usercf", "itemcf", "gdcf"])
def test_cli(folds_dir, algo, capsys):
    extra = ["--iterations", "3", "--embedding-size", "8"] if algo == "gdcf" else []
    assert cf_cli.main([algo, "--data", folds_dir, "--device", "cpu", "--json"] + extra) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    fold = "u1" if algo == "gdcf" else "ua"
    assert out["algo"] == algo and out["fold"] == fold
    assert 0 <= out["precision"] <= 1 and 0 <= out["recall"] <= 1
    m, tests = load_base_test(folds_dir, fold)
    if algo == "gdcf":
        assert len(out["loss"]) == 3 and out["loss"][-1] < out["loss"][0]
        return
    fn = user_cf_recommend if algo == "usercf" else item_cf_recommend
    rec = fn(m, device="cpu").numpy()
    assert (out["recall"], out["precision"], out["f1"]) == cf_eval(rec, tests)
    cf_cli.main([algo, "--data", folds_dir, "--device", "cpu"])
    assert f"{algo} (ua, k=10, top-20): recall=" in capsys.readouterr().out


def test_cli_defaults_to_cuda(folds_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cf_cli.main(["usercf", "--data", folds_dir])
