"""The port's row-sparse optimizers (``train/sparse.py``) and sparse trainer
(``train/sparse_trainer.py``) against the JAX package's on the same NumPy
inputs.

* ``dedup_rows``, ``lazy_adam``, ``rowwise_adagrad`` and
  ``sparse_table_update`` over a few steps on ids that repeat and leave slots
  to the ``vocab`` sentinel: rtol 2e-5, atol 2e-6, as ``tests/test_sparse.py``
  holds the JAX functions to their oracle. Every row no id touched, and the
  last row (which a padding slot reads, clamped), keeps its bits in the table
  and in the state.
* ``fit_minibatch_sparse`` (each epoch's order replayed from the JAX run, as
  ``tests/test_torch_minibatch.py`` does) and ``fit_stream_sparse`` (the NumPy
  order is the JAX package's) on MF and a narrow DeepFM, with both
  optimizers: losses rtol 1e-5, tables, dense params and states atol 1e-5.
* A mesh that is no DeviceMesh, or an unknown strategy, raises; a model
  without the protocol raises.
* CPU tensors take the plain versions (``dedup_rows_plain``,
  ``rowwise_adagrad_plain``), never the kernels' launchers; only CUDA float32
  rows with int32 or int64 ids and a sentinel an int32 key holds take the
  kernels; ``sparse_table_update`` runs whatever ``dedup_rows`` and optimizer
  the module holds at the call (a planted fault replaces them by name). The
  kernels against the plain versions on the card:
  ``tests/test_torch_cuda_kernels.py``, which imports no JAX.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.features import FeatureSpec as JaxSpec
from deeplearningrecommendationsystem_tpu.models import DeepFM as JaxDeepFM
from deeplearningrecommendationsystem_tpu.models import MatrixFactorization as JaxMF
from deeplearningrecommendationsystem_tpu.train import TrainConfig as JaxConfig
from deeplearningrecommendationsystem_tpu.train import Trainer as JaxTrainer
from deeplearningrecommendationsystem_tpu.train import fit_minibatch_sparse as jax_fit_sparse
from deeplearningrecommendationsystem_tpu.train import fit_stream_sparse as jax_fit_stream_sparse
from deeplearningrecommendationsystem_tpu.train import sparse as jax_sparse
from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models import (
    DeepFM,
    LogisticRegression,
    MatrixFactorization,
)
from deeplearningrecommendationsystem_tpu_torch.train import (
    TrainConfig,
    Trainer,
    fit_minibatch_sparse,
    fit_stream_sparse,
    merge_tables,
    pop_tables,
)
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import sparse_rows as cuda_sparse_rows
from deeplearningrecommendationsystem_tpu_torch.train import minibatch
from deeplearningrecommendationsystem_tpu_torch.train import sparse
from jax_order import jax_order
from deeplearningrecommendationsystem_tpu_torch.weights import params_from_jax

V, D, B = 20, 6, 24
RTOL, ATOL = 2e-5, 2e-6
U, I, N, BS, EPOCHS, LR, WD = 30, 40, 450, 64, 2, 0.01, 1e-5
OPTIMIZERS = {"lazy_adam": (sparse.LazyAdamState, jax_sparse.LazyAdamState),
              "rowwise_adagrad": (sparse.RowwiseAdagradState, jax_sparse.RowwiseAdagradState)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test (many small ops; see tests/test_torch_cli_run.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _steps(seed=0, steps=3, high=V - 1):
    """Per step (ids [B], row grads [B, D]): ids from a few values, so they
    repeat and leave slots to the sentinel; none reaches ``high``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, high, B) // 3 * 3, rng.standard_normal((B, D)).astype(np.float32))
            for _ in range(steps)]


def _init(name, table):
    port_cls, jax_cls = OPTIMIZERS[name]
    if name == "lazy_adam":
        return port_cls.init(V, D, device="cpu"), jax_cls.init(V, D)
    return port_cls.init(V, device="cpu"), jax_cls.init(V)


def _state_arrays(state):
    return {k: np.asarray(v) for k, v in vars(state).items()}


def test_dedup_rows_matches_jax():
    ids, g = _steps(1, 1)[0]
    ids[:4] = V - 1  # the last row, repeated
    got = sparse.dedup_rows(torch.from_numpy(ids), torch.from_numpy(g), V)
    want = jax_sparse.dedup_rows(jnp.asarray(ids), jnp.asarray(g), V)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=RTOL, atol=ATOL)
    n = len(np.unique(ids))
    assert (got[0][n:] == V).all() and (got[1][n:] == 0).all()
    assert got[0].dtype == torch.int64


@pytest.mark.parametrize("name", list(OPTIMIZERS))
@pytest.mark.parametrize("entry", ["sparse_table_update", "on_unique_ids"])
def test_optimizer_matches_jax_and_keeps_untouched_rows(name, entry):
    table0 = np.random.default_rng(2).standard_normal((V, D)).astype(np.float32)
    state, jstate = _init(name, table0)
    state0 = {k: v.clone() for k, v in vars(state).items()}
    table, jtable = torch.from_numpy(table0.copy()), jnp.asarray(table0)
    steps = _steps()
    for ids, g in steps:
        if entry == "sparse_table_update":
            table, state = sparse.sparse_table_update(table, state, torch.from_numpy(ids),
                                                      torch.from_numpy(g), 0.05)
            jtable, jstate = jax_sparse.sparse_table_update(jtable, jstate, jnp.asarray(ids),
                                                            jnp.asarray(g), 0.05)
        else:
            uids, ugrads = sparse.dedup_rows(torch.from_numpy(ids), torch.from_numpy(g), V)
            fn = getattr(sparse, name)
            table, state = fn(table, state, uids, ugrads, 0.05)
            juids, jgrads = jax_sparse.dedup_rows(jnp.asarray(ids), jnp.asarray(g), V)
            jtable, jstate = getattr(jax_sparse, name)(jtable, jstate, juids, jgrads, 0.05)
    np.testing.assert_allclose(table.numpy(), np.asarray(jtable), rtol=RTOL, atol=ATOL)
    for k, v in _state_arrays(jstate).items():
        np.testing.assert_allclose(getattr(state, k).numpy(), v, rtol=RTOL, atol=ATOL, err_msg=k)
    touched = np.unique(np.concatenate([ids for ids, _ in steps]))
    untouched = np.setdiff1d(np.arange(V), touched)
    assert V - 1 in untouched and len(untouched) > 1
    assert not np.isin(touched, untouched).any()
    np.testing.assert_array_equal(table.numpy()[untouched], table0[untouched])  # bit for bit
    assert (table.numpy()[touched] != table0[touched]).all(axis=1).all()
    for k, v in vars(state).items():
        if v.dim():
            np.testing.assert_array_equal(v.numpy()[untouched], state0[k].numpy()[untouched])


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_last_row_is_updated_only_when_touched(name):
    """One id, so every slot but the first is padding: the last row moves
    exactly when that id is V - 1, and then as JAX moves it."""
    table0 = np.random.default_rng(3).standard_normal((V, D)).astype(np.float32)
    g = np.random.default_rng(4).standard_normal((B, D)).astype(np.float32)
    for the_id in (V - 1, 5):
        state, jstate = _init(name, table0)
        table = torch.from_numpy(table0.copy())
        ids = np.full(B, the_id)
        sparse.sparse_table_update(table, state, torch.from_numpy(ids), torch.from_numpy(g), 0.05)
        jtable, _ = jax_sparse.sparse_table_update(jnp.asarray(table0), jstate, jnp.asarray(ids),
                                                   jnp.asarray(g), 0.05)
        np.testing.assert_allclose(table.numpy(), np.asarray(jtable), rtol=RTOL, atol=ATOL)
        moved = np.nonzero((table.numpy() != table0).any(axis=1))[0].tolist()
        assert moved == [the_id]


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_all_padding_slots_change_nothing(name):
    table0 = np.random.default_rng(5).standard_normal((V, D)).astype(np.float32)
    state, _ = _init(name, table0)
    before = {k: v.clone() for k, v in vars(state).items()}
    table = torch.from_numpy(table0.copy())
    fn = getattr(sparse, name)
    fn(table, state, torch.full((B,), V), torch.zeros(B, D), 0.05)
    np.testing.assert_array_equal(table.numpy(), table0)
    for k, v in vars(state).items():
        if v.dim():
            torch.testing.assert_close(v, before[k], rtol=0, atol=0)


def _never(*args, **kwargs):
    raise AssertionError("a CPU tensor reached a kernel launcher")


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64], ids=["int32", "int64"])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_cpu_tensors_take_the_plain_versions(monkeypatch, name, id_dtype):
    """On the CPU the dedup and both optimizers are the plain versions bit
    for bit, through ``sparse_table_update`` too, and no launcher is called."""
    monkeypatch.setattr(cuda_sparse_rows, "dedup_rows", _never)
    monkeypatch.setattr(cuda_sparse_rows, "rowwise_adagrad", _never)
    ids, g = _steps(7, 1)[0]
    ids, g = torch.from_numpy(ids).to(id_dtype), torch.from_numpy(g)
    got = sparse.dedup_rows(ids, g, V)
    want = sparse.dedup_rows_plain(ids, g, V)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].dtype == id_dtype
    table0 = torch.from_numpy(np.random.default_rng(8).standard_normal((V, D)).astype(np.float32))
    plain = (sparse.rowwise_adagrad_plain if name == "rowwise_adagrad" else sparse.lazy_adam)
    results = []
    for step in ("update", "plain", "sparse_table_update"):
        table, state = table0.clone(), _init(name, table0)[0]
        if step == "update":
            getattr(sparse, name)(table, state, *got, 0.05)
        elif step == "plain":
            plain(table, state, *want, 0.05)
        else:
            sparse.sparse_table_update(table, state, ids, g, 0.05)
        results.append([table, *vars(state).values()])
    for other in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(results[0], other))


# (rows device, rows dtype, ids dtype, vocab) -> whether the kernels take it
ROUTES = [("cuda", torch.float32, torch.int64, V, True),
          ("cuda", torch.float32, torch.int32, V, True),
          ("cuda", torch.float32, torch.int64, 2**31 - 2, True),
          ("cuda", torch.float32, torch.int64, 2**31 - 1, False),  # the sentinel needs an int32 key
          ("cuda", torch.bfloat16, torch.int64, V, False),
          ("cuda", torch.float64, torch.int64, V, False),
          ("cuda", torch.float32, torch.int16, V, False),
          ("cpu", torch.float32, torch.int64, V, False)]


@pytest.mark.parametrize("device,dtype,id_dtype,vocab,taken", ROUTES)
def test_which_rows_take_the_kernels(device, dtype, id_dtype, vocab, taken):
    def fake(dt, contiguous=True):
        return types.SimpleNamespace(device=torch.device(device), dtype=dt,
                                     is_contiguous=lambda: contiguous)

    assert sparse._on_kernels(fake(id_dtype), vocab, fake(dtype)) is taken
    assert sparse._on_kernels(fake(id_dtype), vocab, fake(torch.float32), fake(dtype)) is taken
    assert sparse._on_kernels(fake(id_dtype), vocab, fake(dtype, contiguous=False)) is False
    assert sparse._on_kernels(fake(id_dtype, contiguous=False), vocab, fake(dtype)) is False


@pytest.mark.parametrize("name", ["dedup_rows", "rowwise_adagrad", "lazy_adam"])
def test_sparse_table_update_runs_the_module_s_functions(monkeypatch, name):
    """``sparse_table_update`` looks ``dedup_rows`` and the optimizer up in the
    module at each call: a replacement set there by name (as the benchmark's
    fault ``accumulator_unchanged`` replaces ``rowwise_adagrad``) is what runs,
    with the step's arguments, and what it returns is the update's result."""
    calls = []
    orig = getattr(sparse, name)

    def recorded(*args, **kwargs):
        calls.append(len(args))
        return orig(*args, **kwargs)

    monkeypatch.setattr(sparse, name, recorded)
    optimizer = "lazy_adam" if name == "lazy_adam" else "rowwise_adagrad"
    table0 = np.random.default_rng(9).standard_normal((V, D)).astype(np.float32)
    table, state = torch.from_numpy(table0.copy()), _init(optimizer, table0)[0]
    ids, g = _steps(9, 1)[0]
    out = sparse.sparse_table_update(table, state, torch.from_numpy(ids), torch.from_numpy(g),
                                     0.05)
    assert calls == [3 if name == "dedup_rows" else 5]
    assert out[0] is table and out[1] is state
    assert not np.array_equal(table.numpy(), table0)


def test_a_replaced_optimizer_is_what_the_trainer_runs(monkeypatch):
    """The benchmark's fault: row-wise AdaGrad whose accumulator is never
    written back, put in by name, changes what ``sparse_table_update``
    leaves in the state and the table."""
    def unchanged(table, state, uids, ugrads, lr, eps=1e-10):
        kept = state.accum.clone()
        out = orig(table, state, uids, ugrads, lr, eps)
        state.accum.copy_(kept)
        return out

    table0 = np.random.default_rng(10).standard_normal((V, D)).astype(np.float32)
    steps = _steps(10, 2)
    runs = []
    orig = sparse.rowwise_adagrad
    for fault in (False, True):
        if fault:
            monkeypatch.setattr(sparse, "rowwise_adagrad", unchanged)
        table, state = torch.from_numpy(table0.copy()), _init("rowwise_adagrad", table0)[0]
        for ids, g in steps:
            sparse.sparse_table_update(table, state, torch.from_numpy(ids), torch.from_numpy(g),
                                       0.05)
        runs.append((table, state.accum))
    assert runs[0][1].any() and not runs[1][1].any()
    assert not torch.equal(runs[0][0], runs[1][0])


def test_unknown_state_raises():
    with pytest.raises(TypeError, match="unknown sparse optimizer state"):
        sparse.sparse_table_update(torch.zeros(V, D), object(), torch.zeros(B, dtype=torch.int64),
                                   torch.zeros(B, D), 0.1)


def test_pop_and_merge_tables():
    params = {"a": torch.zeros(1), "t.x": torch.ones(2), "b": torch.zeros(3)}
    dense, tables = pop_tables(params, {"x": "t.x"})
    assert set(dense) == {"a", "b"} and set(tables) == {"x"} and set(params) == {"a", "t.x", "b"}
    assert merge_tables(dense, {"x": "t.x"}, tables) == params


# ---- the sparse trainer against the JAX one

def _flat(tree, prefix=""):
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    out = {}
    for k, v in tree.items():
        nested = isinstance(v, (dict, list, tuple))
        out.update(_flat(v, f"{prefix}{k}.") if nested else {f"{prefix}{k}": np.asarray(v)})
    return out


def _pair(rng):
    users = rng.integers(0, U, N).astype(np.int32)
    items = rng.integers(0, I, N).astype(np.int32)
    return (users, items), (rng.random(N) < 0.4).astype(np.float32)


def _features(rng):
    x = np.zeros((N, 45), np.float32)
    x[:, 0] = rng.integers(0, U, N)
    x[:, 1] = rng.integers(0, I, N)
    x[:, 2] = rng.random(N)
    x[np.arange(N), 3 + rng.integers(0, 2, N)] = 1
    x[np.arange(N), 5 + rng.integers(0, 21, N)] = 1
    x[:, 26:] = rng.random((N, 19)) < 0.2
    return x, (rng.random(N) < 0.4).astype(np.float32)


SPEC, JAX_SPEC = FeatureSpec(num_users=U, num_items=I), JaxSpec(num_users=U, num_items=I)
MODELS = {
    "mf": (lambda: JaxMF(U, I, 8), lambda: MatrixFactorization(U, I, 8, device="cpu"), _pair),
    "deepfm": (lambda: JaxDeepFM(JAX_SPEC, (16, 8, 1), 8, robust_init=True),
               lambda: DeepFM(SPEC, (16, 8, 1), 8, robust_init=True, device="cpu"), _features),
}


def _tree(batch, fn):
    return tuple(fn(a) for a in batch) if isinstance(batch, tuple) else fn(batch)


@pytest.mark.parametrize("optimizer", list(OPTIMIZERS))
@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("source", ["minibatch", "stream"])
def test_sparse_trainer_matches_jax(monkeypatch, source, model, optimizer):
    jax_model, port_model, make = MODELS[model]
    batch, y = make(np.random.default_rng(6))
    params = jax.tree.map(np.asarray, jax_model().init(jax.random.PRNGKey(3)))
    key = jax.random.PRNGKey(8)
    cfg = dict(learning_rate=LR, weight_decay=WD, epochs=EPOCHS)
    jtrainer = JaxTrainer(jax_model(), JaxConfig(**cfg))
    trainer = Trainer(params_from_jax(port_model(), params), TrainConfig(**cfg), device="cpu")
    if source == "minibatch":
        want = jax_fit_sparse(jtrainer, key, (_tree(batch, jnp.asarray), jnp.asarray(y)), BS,
                              optimizer=optimizer, params=jax.tree.map(jnp.asarray, params))
        monkeypatch.setattr(minibatch, "epoch_order", jax_order(key))
        got = fit_minibatch_sparse(trainer, 0, (_tree(batch, torch.from_numpy),
                                                torch.from_numpy(y)), BS, optimizer=optimizer)
    else:
        want = jax_fit_stream_sparse(jtrainer, key, (batch, y), BS, optimizer=optimizer,
                                     params=jax.tree.map(jnp.asarray, params), seed=3)
        got = fit_stream_sparse(trainer, 0, (batch, y), BS, optimizer=optimizer, seed=3)
    assert set(got.history) == {"train_loss"} and got.history["train_loss"].shape == (EPOCHS,)
    np.testing.assert_allclose(got.history["train_loss"].numpy(),
                               np.asarray(want.history["train_loss"]), rtol=1e-5)
    want_params = _flat(want.params)
    assert set(got.params) == set(want_params)
    for k, v in got.params.items():
        np.testing.assert_allclose(v.numpy(), want_params[k], atol=1e-5, err_msg=k)
    # the module holds the trained params
    for k, v in trainer.model.named_parameters():
        torch.testing.assert_close(v.detach(), got.params[k], rtol=0, atol=0)
    states = got.opt_state["sparse"]
    assert set(states) == set(want.opt_state["sparse"]) == set(trainer.model.sparse_tables)
    for name, jstate in want.opt_state["sparse"].items():
        for k, v in _state_arrays(jstate).items():
            np.testing.assert_allclose(getattr(states[name], k).numpy(), v, atol=1e-5,
                                       err_msg=f"{name}.{k}")
    assert bool(got.opt_state["dense"]) == (model == "deepfm")


def test_mesh_raises():
    trainer = Trainer(MatrixFactorization(U, I, 8, device="cpu"), TrainConfig(epochs=1),
                      device="cpu")
    (batch, y) = _pair(np.random.default_rng(0))
    """A mesh is a ``parallel/mesh.py::make_mesh`` DeviceMesh (the mesh runs
    are ``tests/test_torch_parallel.py``'s), and the lookup strategy one of two."""
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    with pytest.raises(TypeError, match="DeviceMesh"):
        fit_minibatch_sparse(trainer, 0, (_tree(batch, torch.from_numpy), torch.from_numpy(y)),
                             BS, mesh=mesh)
    with pytest.raises(TypeError, match="DeviceMesh"):
        fit_stream_sparse(trainer, 0, (batch, y), BS, mesh=mesh)
    with pytest.raises(ValueError, match="ep_strategy"):
        fit_stream_sparse(trainer, 0, (batch, y), BS, ep_strategy="gather")


def test_model_without_the_protocol_raises():
    trainer = Trainer(LogisticRegression(SPEC, device="cpu"), TrainConfig(epochs=1), device="cpu")
    x, y = _features(np.random.default_rng(0))
    with pytest.raises(TypeError, match="sparse-table protocol"):
        fit_minibatch_sparse(trainer, 0, (torch.from_numpy(x), torch.from_numpy(y)), BS)
    (batch, y) = _pair(np.random.default_rng(0))
    with pytest.raises(ValueError, match="adamw"):
        fit_minibatch_sparse(Trainer(MatrixFactorization(U, I, 8, device="cpu"),
                                     TrainConfig(epochs=1), device="cpu"),
                             0, (_tree(batch, torch.from_numpy), torch.from_numpy(y)), BS,
                             optimizer="adamw")
