"""The port's multi-process runtime (``runtime/distributed.py``), its scaling
model (``runtime/scaling_model.py``), its native parser (``data/native.py``)
and the CLIs' ``--mesh``.

* without a process group the runtime answers as the JAX package does in one
  process (rank 0 of 1); on 2 Gloo ranks, rank 0 alone is primary and the
  ranks split n examples as the JAX function does; a spawn whose ranks
  outlive its deadline is killed and raises;
* ``cli/run.py`` and ``cli/serve.py`` exit with a message where ``--mesh``
  asks for other than the world's ranks, or where there is no process group;
  ``cli/serve.py --mesh 1,2`` on 2 ranks serves MF from row-sharded tables,
  rank 0's answers (each broadcast to the worker rank) the lists and scores of
  the dense server over the same trained weights;
* ``predict_weak_scaling`` equals the JAX function given the same constants
  dict, and ``program_costs`` counts 2 * 64 * 128 * 32 FLOPs for a
  [64, 128] @ [128, 32] product and its operands' and result's bytes, no
  bytes for views and an in-place op's input read and written;
* the native parser loads the synthetic fixture to the arrays of the port's
  NumPy path and of the JAX package's native parser, and says it ran.
"""

import os
import time

import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.data import MovieLens100K as JaxMovieLens
from deeplearningrecommendationsystem_tpu.runtime import scaling_model as jax_scaling
from deeplearningrecommendationsystem_tpu_torch.cli import run as cli_run
from deeplearningrecommendationsystem_tpu_torch.cli import serve as cli_serve
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, native
from deeplearningrecommendationsystem_tpu_torch.data.synthetic import write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.runtime import distributed, scaling_model

import torch_ranks

DEADLINE_S = 120.0


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    # 300 items: with fewer a user can have every item excluded, and the sampler
    # then emits the out-of-range id I (a dense lookup clamps it, a sharded one
    # gives a zero row, in both packages)
    return write_ml100k_format(str(tmp_path_factory.mktemp("mlr")), seed=5, num_users=40,
                               num_items=300, num_ratings=2400)


def test_one_process_is_rank_0_of_1():
    assert distributed.is_primary()
    assert distributed.host_local_slice(11) == (0, 11)
    assert distributed.local_device("cpu") == torch.device("cpu")


@pytest.fixture(scope="module")
def two_ranks():
    return distributed.spawn(torch_ranks.collectives_rank, 2, deadline_s=DEADLINE_S)


def test_ranks_and_slices_on_two_ranks(two_ranks):
    assert [o["primary"] for o in two_ranks] == [True, False]
    assert [o["slice"] for o in two_ranks] == [(0, 5), (5, 11)]


def test_cli_mesh_must_match_the_world(two_ranks, data_dir):
    for o in two_ranks:
        assert o["mesh_ok"] == (1, 2)
        assert "needs 4 ranks and this run has 2" in o["mesh_wrong"]
        assert "torchrun --nproc-per-node=4" in o["mesh_wrong"]
    # one process, no process group: both CLIs exit before training
    with pytest.raises(SystemExit, match="no process group"):
        cli_run.main(["--model", "mf", "--device", "cpu", "--data", data_dir, "--mesh", "1,2"])
    args = cli_serve.parser().parse_args(["--model", "mf", "--data", data_dir, "--device",
                                          "cpu", "--mesh", "2,1"])
    with pytest.raises(SystemExit, match="no process group"):
        cli_serve.build_server(args)


def test_a_spawn_past_its_deadline_is_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="deadline"):
        distributed.spawn(torch_ranks.sleeping_rank, 2, args=(600.0,), deadline_s=3.0)
    assert time.monotonic() - t0 < 60.0


def test_sharded_serve_cli_matches_the_dense_server(data_dir):
    rank0, calls = distributed.spawn(torch_ranks.serve_rank, 2, args=(data_dir,),
                                     deadline_s=DEADLINE_S)
    assert calls == 3  # the worker made every call rank 0 broadcast
    args = cli_serve.parser().parse_args(["--model", "mf", "--data", data_dir, "--epochs", "2",
                                          "--device", "cpu"])
    dense = cli_serve.build_server(args)
    try:
        want = [dense.dispatch("GET", "/v1/recommend?user=3&k=5", None),
                dense.dispatch("POST", "/v1/recommend", {"users": [0, 7], "k": 4}),
                dense.dispatch("POST", "/v1/score", {"user": 2, "items": [0, 5, 9]})]
    finally:
        dense.httpd.server_close()
    for (code, got), (wcode, w) in zip(rank0, want):
        assert code == wcode == 200
        if "items" in w:
            assert got["items"] == w["items"]
            np.testing.assert_allclose(got["scores"], w["scores"], rtol=1e-5)
        else:
            np.testing.assert_allclose(got["scores"], w["scores"], rtol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_predict_weak_scaling_is_the_jax_function(n, dtype):
    args = (3.1e9, 2.2e8, 4.7e7, n)
    got = scaling_model.predict_weak_scaling(*args, chip=jax_scaling.V5E, dtype=dtype)
    want = jax_scaling.predict_weak_scaling(*args, chip=jax_scaling.V5E, dtype=dtype)
    assert got == pytest.approx(want, rel=1e-12)
    h100 = scaling_model.predict_weak_scaling(*args, dtype=dtype)
    peak = scaling_model.H100["flops_bf16" if dtype == "bf16" else "flops_f32"]
    assert h100["compute_ms"] == pytest.approx(3.1e9 / peak * 1e3)


def test_program_costs_counts_a_product():
    a, b = torch.randn(64, 128), torch.randn(128, 32)
    costs = scaling_model.program_costs(torch.matmul, a, b)
    assert costs["flops"] == 2 * 64 * 128 * 32
    assert costs["hbm_bytes"] == (64 * 128 + 128 * 32 + 64 * 32) * 4
    # a view moves nothing; an in-place op reads and writes its input
    views = scaling_model.program_costs(lambda x: x.t().detach().expand(2, 128, 64), a)
    assert views["hbm_bytes"] == 0
    assert scaling_model.program_costs(lambda x: x.mul_(2.0), a.clone())["hbm_bytes"] == (
        2 * 64 * 128 * 4)
    assert scaling_model.grad_bytes_of({"a": a, "b": b}) == (64 * 128 + 128 * 32) * 4


def test_native_parser_matches_numpy_and_jax(data_dir):
    got = MovieLens100K(data_dir, seed=0, use_native=True)
    assert got.parser == "native", native.build_error()
    assert native.available() and native.library_path().exists()
    plain = MovieLens100K(data_dir, seed=0)
    assert plain.parser == "numpy"
    want = JaxMovieLens(data_dir, seed=0, use_native=True)
    for other in (plain, want):
        np.testing.assert_array_equal(got.user_features, other.user_features)
        np.testing.assert_array_equal(got.item_features, other.item_features)
        assert got.occupation_categories == other.occupation_categories
        assert got.gender_categories == other.gender_categories
        for split in ("data", "train", "valid", "test"):
            for key in ("user", "item"):
                np.testing.assert_array_equal(getattr(got, split)[key],
                                              getattr(other, split)[key])


def test_native_parser_reports_a_failed_build(monkeypatch, data_dir):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "library_path", lambda: native.BUILD_DIR / "absent.so")
    monkeypatch.setenv("CXX", os.path.join(data_dir, "no-such-compiler"))
    got = MovieLens100K(data_dir, seed=0, use_native=True)
    assert got.parser == "numpy"
    assert not native.available() and native.build_error()
