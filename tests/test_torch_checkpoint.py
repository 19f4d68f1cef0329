"""The port's checkpoints (``runtime/checkpoint.py``), ``Recommender.from_checkpoint``
and ``cli/serve.py --checkpoint``, on the CPU.

* the round trip of ``{params, opt_state, rng, step}``, the sparse trainer's
  states as plain dicts, and ``max_to_keep``;
* a template whose names or shapes differ raises;
* 3 + 3 full-batch epochs resumed from a checkpoint equal 6 uninterrupted
  ones (atol 1e-6; on the CPU they give the same bits), and both equal the
  JAX ``Trainer``'s 6-epoch run from the same weights (losses rtol 1e-5,
  params atol 1e-5, as ``tests/test_torch_trainer.py``);
* ``Recommender.from_checkpoint`` serves the saved params, and
  ``build_server`` with ``--checkpoint`` answers as the in-memory
  ``Recommender`` of the model that was saved.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.models import MatrixFactorization as JaxMF
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu_torch import experiments
from deeplearningrecommendationsystem_tpu_torch.cli import serve
from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.data import MovieLens100K, write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization, ServingContext
from deeplearningrecommendationsystem_tpu_torch.runtime.checkpoint import CheckpointManager
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender
from deeplearningrecommendationsystem_tpu_torch.train import (
    LazyAdamState,
    RowwiseAdagradState,
    TrainConfig,
    Trainer,
)
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

U, I, D, N, LR, WD = 30, 40, 8, 200, 0.01, 1e-5


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"user": torch.randn(U, D, generator=g), "item": torch.randn(I, D, generator=g)}


def test_round_trip_and_max_to_keep(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(device="cpu")
    gen = torch.Generator().manual_seed(3)
    for step in range(1, 6):
        opt = {"user": {"step": torch.tensor(float(step)), "exp_avg": torch.full((U, D), step)}}
        mgr.save(step, _params(step), opt_state=opt, rng=gen)
    assert mgr.steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]  # no temporary directory left
    state = mgr.restore(device="cpu")
    assert state["step"] == 5
    for k, v in _params(5).items():
        torch.testing.assert_close(state["params"][k], v, rtol=0, atol=0)
    assert float(state["opt_state"]["user"]["step"]) == 5.0
    again = torch.Generator()
    again.set_state(state["rng"].cpu())
    assert torch.equal(torch.rand(4, generator=again), torch.rand(4, generator=gen))
    assert mgr.restore(step=3, device="cpu")["step"] == 3
    mgr.save(9, _params(9), rng=7)
    assert int(mgr.restore(device="cpu")["rng"]) == 7
    mgr.close()


def test_sparse_states_save_as_plain_dicts(tmp_path):
    states = {"user": LazyAdamState.init(U, D, device="cpu"),
              "item": RowwiseAdagradState.init(I, 0.5, device="cpu")}
    states["user"].t += 3
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _params(), opt_state={"dense": {}, "sparse": states})
    out = mgr.restore(device="cpu")["opt_state"]["sparse"]
    assert set(out["user"]) == {"mv", "t"} and set(out["item"]) == {"accum"}
    assert out["user"]["mv"].shape == (U, 2 * D) and int(out["user"]["t"]) == 3
    torch.testing.assert_close(out["item"]["accum"], torch.full((I,), 0.5))
    template = {"opt_state": {"dense": {}, "sparse": states}}
    assert mgr.restore(template=template, device="cpu")["step"] == 1


@pytest.mark.parametrize("bad", ["shape", "name", "missing"])
def test_template_mismatch_raises(tmp_path, bad):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _params())
    template = {"params": _params()}
    if bad == "shape":
        template["params"]["item"] = torch.zeros(I + 1, D)
    elif bad == "name":
        template["params"]["items"] = template["params"].pop("item")
    else:
        template["opt_state"] = {"user": torch.zeros(1)}
    with pytest.raises(ValueError, match="checkpoint"):
        mgr.restore(template=template, device="cpu")
    assert mgr.restore(template={"params": _params()}, device="cpu")["step"] == 1
    # the JAX CLI's template, the bare params, does not match what save wrote
    with pytest.raises(ValueError, match="missing"):
        mgr.restore(template=_params(), device="cpu")


def _splits():
    rng = np.random.default_rng(11)
    users, items = rng.integers(0, U, N), rng.integers(0, I, N)
    return (users, items), (rng.random(N) < 0.4).astype(np.float32)


def _port_fit(model, epochs, **kw):
    (u, i), y = _splits()
    trainer = Trainer(model, TrainConfig(learning_rate=LR, weight_decay=WD, epochs=epochs,
                                         track_metrics=False), device="cpu")
    return trainer.fit(((torch.from_numpy(u), torch.from_numpy(i)), torch.from_numpy(y)), **kw)


def test_resumed_run_equals_uninterrupted_and_jax(tmp_path):
    params = {k: np.array(v) for k, v in JaxMF(U, I, D).init(jax.random.PRNGKey(3)).items()}
    whole = _port_fit(params_from_jax(MatrixFactorization(U, I, D, device="cpu"), params), 6)

    first = _port_fit(params_from_jax(MatrixFactorization(U, I, D, device="cpu"), params), 3)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, first.params, opt_state=first.opt_state)
    fresh = MatrixFactorization(U, I, D, device="cpu")
    state = mgr.restore(template={"params": fresh.state_dict()}, device="cpu")
    second = _port_fit(fresh, 3, params=state["params"], opt_state=state["opt_state"])

    resumed_losses = torch.cat([first.history["train_loss"], second.history["train_loss"]])
    torch.testing.assert_close(resumed_losses, whole.history["train_loss"], rtol=0, atol=1e-6)
    for k in whole.params:
        torch.testing.assert_close(second.params[k], whole.params[k], rtol=0, atol=1e-6)

    (u, i), y = _splits()
    want = JaxTrainer(JaxMF(U, I, D), JaxConfig(learning_rate=LR, weight_decay=WD, epochs=6,
                                                track_metrics=False)).fit(
        jax.random.PRNGKey(0), ((jnp.asarray(u), jnp.asarray(i)), jnp.asarray(y)),
        params={k: jnp.asarray(v) for k, v in params.items()})
    for run in (resumed_losses, whole.history["train_loss"]):
        np.testing.assert_allclose(run.numpy(), np.asarray(want.history["train_loss"]), rtol=1e-5)
    for k in whole.params:
        np.testing.assert_allclose(second.params[k].numpy(), np.asarray(want.params[k]),
                                   atol=1e-5)


def test_recommender_from_checkpoint(tmp_path):
    model = MatrixFactorization(U, I, D, generator=torch.Generator().manual_seed(1), device="cpu")
    CheckpointManager(str(tmp_path)).save(1, model.state_dict())
    ctx = ServingContext(torch.zeros((U, 24)), torch.zeros((I, 19)))
    seen = np.random.default_rng(0).random((U, I)) < 0.2
    served = Recommender.from_checkpoint(MatrixFactorization(U, I, D, device="cpu"),
                                         str(tmp_path), ctx, seen=seen, device="cpu")
    torch.testing.assert_close(served.model.user.detach(), model.user.detach(), rtol=0, atol=0)
    want = Recommender(model, ctx, seen=seen, device="cpu").top_k(5)
    np.testing.assert_array_equal(served.top_k(5), want)
    with pytest.raises(ValueError, match="checkpoint"):
        Recommender.from_checkpoint(MatrixFactorization(U, I + 1, D, device="cpu"),
                                    str(tmp_path), ctx, device="cpu")


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    return write_ml100k_format(str(tmp_path_factory.mktemp("ml")), seed=5, num_users=60,
                               num_items=150, num_ratings=3000)


def test_build_server_serves_a_checkpoint(dataset_dir, tmp_path):
    cfg = PRESETS["mf"].replace(epochs=2, track_metrics=False)
    data = MovieLens100K(dataset_dir, seed=0)
    res = experiments.run_experiment(cfg, data=data, device="cpu")
    CheckpointManager(str(tmp_path)).save(2, res.params)
    args = argparse.Namespace(model="mf", data=dataset_dir, epochs=None, seed=0, device="cpu",
                              checkpoint=str(tmp_path), mesh=None, host="127.0.0.1", port=0,
                              exclude_seen=True)
    server = serve.build_server(args)
    try:
        code, payload = server.dispatch("POST", "/v1/recommend", {"users": [0, 7, 59], "k": 10})
        assert code == 200
        torch.testing.assert_close(server.recommender.model.user.detach(), res.params["user"],
                                   rtol=0, atol=0)
        model = experiments.build_model(cfg, data)
        model.load_state_dict(res.params)
        seen = data.seen_mask(data.train, data.valid, data.test)
        want = Recommender(model, res.ctx, seen=seen, device="cpu").top_k(10, [0, 7, 59])
        assert payload["items"] == want.tolist()
    finally:
        server.httpd.server_close()
