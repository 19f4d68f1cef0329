"""The port stands alone, and its device rule holds.

* No file of ``deeplearningrecommendationsystem_tpu_torch`` and not
  ``chip_smoke.py`` imports ``jax``, ``jaxlib`` or the JAX package.
* Entry points default to CUDA and raise where it is absent, unless the caller
  passes ``device="cpu"``.
* A CUDA tensor given to a kernel wrapper (top-k, gather, onehot_grad, the
  fused MF and LR trainers, the AFM attention pool and its backward, the
  fused DIN head and its backward, the DIN attention pool) goes to its kernel
  launcher and never to the plain version; there is no fallback.
* Every id lookup of the feature models (DeepFM, WideDeep, NFM, PNN, DCN,
  DeepCrossing, FFM) goes through the gather and onehot_grad wrappers.
* DIN's routes: training and evaluation go through the DIN head wrappers,
  the window catalog scorer through the DIN attention pool, the masked
  routes through neither.
* DIEN and NeuralCF look every id up through the gather and onehot_grad
  wrappers, and DIEN takes no DIN head or pool wrapper; AutoRec looks
  nothing up.
* The minibatch trainers look ids up through the gather and onehot_grad
  wrappers; the sparse trainer gathers its table rows through the gather
  wrapper and never forms a table gradient (no onehot_grad).
* The row-sparse update (``train/sparse.py``'s ``dedup_rows`` and
  ``rowwise_adagrad``) hands CUDA float32 rows to its kernel launchers
  (``ops/cuda/sparse_rows.py``) and never to the plain version; the launchers
  refuse CPU tensors.
* Classic CF (UserCF, ItemCF, GDCF) takes every top-k through the
  ``topk_scores`` wrapper, never through ``stable_top_k`` or a library
  top-k; on a CUDA tensor that is the kernel.
* The streaming loader's pinned, side-stream copy delivers every batch whole
  on the card (a CUDA test).
* The parallel layer: its modules (and ``tests/torch_ranks.py``, which the
  multi-rank tests spawn) import no JAX; ``runtime/distributed.py``'s
  ``local_device`` and ``initialize`` follow the device rule; a pair of
  transport and device with no transport raises in ``parallel/collectives.py``
  instead of switching transports; on 2 Gloo ranks every EP lookup goes
  through the gather and onehot_grad wrappers, and every sharded top-k
  through the two top-k wrappers.

This file imports neither JAX nor the JAX package, so its CUDA test also runs
on a machine that has only the port (``-m cuda --noconftest``).
"""

import argparse
import ast
import pathlib
import types

import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu_torch import cf, experiments
from deeplearningrecommendationsystem_tpu_torch.cli import cf as cf_cli
from deeplearningrecommendationsystem_tpu_torch.cli import run as run_cli
from deeplearningrecommendationsystem_tpu_torch.cli import serve
from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.data.stream import (
    StreamingLoader,
    prefetch_to_device,
)
from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.features import FeatureSpec
from deeplearningrecommendationsystem_tpu_torch.models import (
    AFM,
    DCN,
    DIEN,
    DIN,
    FFM,
    NFM,
    PNN,
    DeepCrossing,
    DeepFM,
    AutoRec,
    LogisticRegression,
    MatrixFactorization,
    NeuralCF,
    ServingContext,
    WideDeep,
)
from deeplearningrecommendationsystem_tpu_torch.ops import afm_attention, gather, lr_epoch, mf_epoch
from deeplearningrecommendationsystem_tpu_torch.ops import din_attention, din_head
from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import afm_attention as cuda_afm
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_attention as cuda_din_attention
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import din_head as cuda_din_head
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import gather as cuda_gather
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import lr_epoch as cuda_lr_epoch
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as cuda_mf_epoch
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as cuda_topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import sparse_rows as cuda_sparse_rows
from deeplearningrecommendationsystem_tpu_torch.parallel import collectives
from deeplearningrecommendationsystem_tpu_torch.runtime import distributed
from deeplearningrecommendationsystem_tpu_torch.runtime.checkpoint import CheckpointManager
from deeplearningrecommendationsystem_tpu_torch.sampling import NegativeSampler
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender
from deeplearningrecommendationsystem_tpu_torch.train import (
    LazyAdamState,
    RowwiseAdagradState,
    TrainConfig,
    Trainer,
    fit_minibatch,
    fit_minibatch_sparse,
    fit_stream,
    fit_stream_sparse,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "deeplearningrecommendationsystem_tpu_torch"
PORT_FILES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                              ROOT / "tests" / "torch_ranks.py"]
FORBIDDEN = {"jax", "jaxlib", "deeplearningrecommendationsystem_tpu"}
WRAPPERS = ["topk_serve_matmul", "topk_scores"]


def _imported(tree: ast.AST):
    """Every module name an import statement, ``__import__`` or
    ``importlib.import_module`` with a literal name brings in."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
            if name in ("__import__", "import_module"):
                yield node.args[0].value


def test_port_files_are_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert {"chip_smoke.py", "deeplearningrecommendationsystem_tpu_torch/serving.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/cuda/serving_topk.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/cuda/gather.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/cuda/mf_epoch.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/cuda/lr_epoch.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/cuda/afm_attention.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/lr_epoch.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/afm_attention.py",
            "deeplearningrecommendationsystem_tpu_torch/models/lr.py",
            "deeplearningrecommendationsystem_tpu_torch/models/afm.py",
            "deeplearningrecommendationsystem_tpu_torch/models/din.py",
            "deeplearningrecommendationsystem_tpu_torch/models/deepfm.py",
            "deeplearningrecommendationsystem_tpu_torch/models/ffm.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/din_head.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/din_attention.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/cuda/din_head.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/cuda/din_attention.py",
            "deeplearningrecommendationsystem_tpu_torch/train/trainer.py",
            "deeplearningrecommendationsystem_tpu_torch/experiments.py",
            "deeplearningrecommendationsystem_tpu_torch/cli/serve.py",
            "deeplearningrecommendationsystem_tpu_torch/cli/run.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/gru.py",
            "deeplearningrecommendationsystem_tpu_torch/models/dien.py",
            "deeplearningrecommendationsystem_tpu_torch/models/neuralcf.py",
            "deeplearningrecommendationsystem_tpu_torch/models/autorec.py",
            "deeplearningrecommendationsystem_tpu_torch/runtime/logging.py",
            "deeplearningrecommendationsystem_tpu_torch/runtime/plotting.py",
            "deeplearningrecommendationsystem_tpu_torch/runtime/profiler.py",
            "deeplearningrecommendationsystem_tpu_torch/runtime/checkpoint.py",
            "deeplearningrecommendationsystem_tpu_torch/data/stream.py",
            "deeplearningrecommendationsystem_tpu_torch/train/minibatch.py",
            "deeplearningrecommendationsystem_tpu_torch/train/sparse.py",
            "deeplearningrecommendationsystem_tpu_torch/ops/cuda/sparse_rows.py",
            "deeplearningrecommendationsystem_tpu_torch/train/sparse_trainer.py",
            "deeplearningrecommendationsystem_tpu_torch/cf/neighborhood.py",
            "deeplearningrecommendationsystem_tpu_torch/cf/gdcf.py",
            "deeplearningrecommendationsystem_tpu_torch/cli/cf.py",
            "deeplearningrecommendationsystem_tpu_torch/parallel/__init__.py",
            "deeplearningrecommendationsystem_tpu_torch/parallel/mesh.py",
            "deeplearningrecommendationsystem_tpu_torch/parallel/collectives.py",
            "deeplearningrecommendationsystem_tpu_torch/parallel/data.py",
            "deeplearningrecommendationsystem_tpu_torch/parallel/embedding.py",
            "deeplearningrecommendationsystem_tpu_torch/parallel/ep.py",
            "deeplearningrecommendationsystem_tpu_torch/parallel/serving.py",
            "deeplearningrecommendationsystem_tpu_torch/runtime/distributed.py",
            "deeplearningrecommendationsystem_tpu_torch/runtime/scaling_model.py",
            "deeplearningrecommendationsystem_tpu_torch/data/native.py",
            "tests/torch_ranks.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if str(m).split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_import_scan_catches_jax():
    tree = ast.parse("import jax.numpy as jnp\nfrom deeplearningrecommendationsystem_tpu import x\n"
                     "importlib.import_module('jaxlib')\n")
    assert [str(m).split(".")[0] for m in _imported(tree)] == [
        "jax", "deeplearningrecommendationsystem_tpu", "jaxlib"]


# ---- device rule

def _ctx(U=4, I=6):
    return ServingContext(torch.zeros((U, 24)), torch.zeros((I, 19)))


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


ENTRY_POINTS = {
    "resolve_device": lambda: resolve_device(),
    "MatrixFactorization": lambda: MatrixFactorization(4, 6, 8),
    "LogisticRegression": lambda: LogisticRegression(),
    "AFM": lambda: AFM(),
    "DeepFM": lambda: DeepFM(),
    "WideDeep": lambda: WideDeep(),
    "NFM": lambda: NFM(),
    "PNN": lambda: PNN(),
    "DCN": lambda: DCN(),
    "DeepCrossing": lambda: DeepCrossing(),
    "FFM": lambda: FFM(),
    "DIN": lambda: DIN(10),
    "DIEN": lambda: DIEN(10),
    "NeuralCF": lambda: NeuralCF(4, 6, 8, (8, 4)),
    "AutoRec": lambda: AutoRec(6, 4),
    "Recommender": lambda: Recommender(MatrixFactorization(4, 6, 8, device="cpu"), _ctx()),
    "Trainer": lambda: Trainer(MatrixFactorization(4, 6, 8, device="cpu"), TrainConfig()),
    "NegativeSampler": lambda: NegativeSampler(np.zeros((4, 6), dtype=bool), seed=0),
    "run_experiment": lambda: experiments.run_experiment(PRESETS["mf"], data_path="unused"),
    "build_server": lambda: serve.build_server(
        serve.parser().parse_args(["--model", "mf", "--data", "unused"])),
    "cli.run": lambda: run_cli.main(["--model", "mf", "--data", "unused"]),
    "cli.cf": lambda: cf_cli.main(["usercf", "--data", "unused"]),
    "user_cf_recommend": lambda: cf.user_cf_recommend(np.zeros((4, 6), np.float32)),
    "item_cf_recommend": lambda: cf.item_cf_recommend(np.zeros((4, 6), np.float32)),
    "gdcf_train": lambda: cf.gdcf_train(np.zeros((4, 6), np.float32)),
    "CheckpointManager.restore": lambda: _checkpoint().restore(),
    "Recommender.from_checkpoint": lambda: Recommender.from_checkpoint(
        MatrixFactorization(4, 6, 8, device="cpu"), _checkpoint().directory, _ctx()),
    "StreamingLoader": lambda: StreamingLoader(np.zeros(4), 2),
    "prefetch_to_device": lambda: next(prefetch_to_device(iter([np.zeros(2)]))),
    "fit_minibatch": lambda: fit_minibatch(_cpu_trainer_on_cuda(), 0, _pairs(), 2),
    "fit_stream": lambda: fit_stream(_cpu_trainer_on_cuda(), 0, _pairs(np), 2),
    "fit_minibatch_sparse": lambda: fit_minibatch_sparse(_cpu_trainer_on_cuda(), 0, _pairs(), 2),
    "fit_stream_sparse": lambda: fit_stream_sparse(_cpu_trainer_on_cuda(), 0, _pairs(np), 2),
    "LazyAdamState.init": lambda: LazyAdamState.init(6, 8),
    "RowwiseAdagradState.init": lambda: RowwiseAdagradState.init(6),
    "local_device": lambda: distributed.local_device(),
    "initialize": lambda: distributed.initialize(),
}


def _checkpoint():
    import tempfile

    mgr = CheckpointManager(tempfile.mkdtemp())
    mgr.save(1, {"user": torch.zeros(4, 8), "item": torch.zeros(6, 8)})
    return mgr


def _cpu_trainer_on_cuda():
    """The Trainer as a trainer's caller builds it: on its default device."""
    return Trainer(MatrixFactorization(4, 6, 8, device="cpu"), TrainConfig(epochs=1))


def _pairs(lib=torch):
    ids = lib.zeros(4, dtype=lib.int64)
    return (ids, ids), lib.zeros(4, dtype=lib.float32)


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_raise_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[name]()


def test_cpu_only_when_asked(no_cuda):
    rec = Recommender(MatrixFactorization(4, 6, 8, device="cpu"), _ctx(), device="cpu")
    assert rec.device == torch.device("cpu")
    assert rec.top_k(2).shape == (4, 2)
    with pytest.raises(ValueError):
        resolve_device("meta")


# ---- no fallback from a CUDA tensor to the plain version

def _fake_cuda(*shape):
    """Stands in for a CUDA tensor where there is no card: the wrappers read
    only its device before they hand it on."""
    return types.SimpleNamespace(device=torch.device("cuda"), shape=torch.Size(shape))


def _never(*args, **kwargs):
    raise AssertionError("a CUDA tensor reached the plain version")


def _args(name, make):
    return (make(5, 8), make(9, 8), make(5, 9)) if name == "topk_serve_matmul" else (
        make(5, 9), make(5, 9))


@pytest.mark.parametrize("name", WRAPPERS)
def test_cuda_tensors_go_to_the_launcher(monkeypatch, name):
    calls = []
    monkeypatch.setattr(topk, f"{name}_plain", _never)
    monkeypatch.setattr(cuda_topk, name, lambda *a: calls.append(a[-1]) or "launched")
    assert getattr(topk, name)(*_args(name, _fake_cuda), k=3) == "launched"
    assert calls == [3]


@pytest.mark.parametrize("name", WRAPPERS)
def test_cpu_tensors_take_the_plain_version(monkeypatch, name):
    monkeypatch.setattr(cuda_topk, name, _never)
    vals, ids = getattr(topk, name)(*_args(name, torch.zeros), k=3)
    assert vals.shape == ids.shape == (5, 3)


def test_on_cpu_decides_by_the_first_tensor():
    cpu = torch.zeros(2)
    assert topk._on_cpu(cpu, cpu) is True
    assert topk._on_cpu(_fake_cuda(2), cpu) is False  # the launcher then rejects the CPU tensor
    with pytest.raises(ValueError):
        topk._on_cpu(cpu, torch.zeros(2, device="meta"))


def test_launchers_reject_cpu_tensors():
    for name in WRAPPERS:
        with pytest.raises(ValueError, match="CUDA"):
            getattr(cuda_topk, name)(*_args(name, torch.zeros), k=3)


def _calls(node):
    return [n.func.id for n in ast.walk(node)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)]


def test_wrapper_source_has_no_fallback():
    """Read the wrappers: no ``try``; the plain version is called once, inside
    ``if _on_cpu(...)``; the launchers call no plain version at all."""
    tree = ast.parse(pathlib.Path(topk.__file__).read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for name in WRAPPERS:
        fn = funcs[name]
        assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
        (branch,) = [n for n in fn.body if isinstance(n, ast.If)]
        assert _calls(branch.test) == ["_on_cpu"]
        plain = [c for c in _calls(fn) if c.endswith("_plain")]
        assert plain == [f"{name}_plain"] == [c for c in _calls(branch) if c.endswith("_plain")]
    launchers = pathlib.Path(cuda_topk.__file__).read_text()
    assert "_plain" not in launchers and "try:" not in launchers


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", WRAPPERS)
def test_cuda_tensor_launches_the_kernel(cuda, monkeypatch, name):
    monkeypatch.setattr(topk, f"{name}_plain", _never)
    launcher = getattr(cuda_topk, name)
    before = launcher.launches
    args = _args(name, lambda *s: torch.randn(s, device=cuda))
    if name == "topk_serve_matmul":
        args = (args[0], args[1], args[2] > 1.0)
    else:
        args = (args[0], args[1] > 1.0)
    vals, ids = getattr(topk, name)(*args, k=3)
    torch.cuda.synchronize()
    assert launcher.launches == before + 1
    assert vals.device.type == "cuda" and ids.dtype == torch.int32 and ids.shape == (5, 3)


# ---- the training slice's wrappers: gather, onehot_grad, the fused MF trainer

TRAIN_WRAPPERS = {
    # wrapper module, its name, the launcher module and name, and its arguments
    "gather_rows_kernel": (gather, cuda_gather, "gather_rows",
                           lambda make: (make(9, 4), make(5))),
    "onehot_grad": (gather, cuda_gather, "onehot_grad",
                    lambda make: (make(5), make(5, 4), 9)),
    "mf_fullbatch_train": (mf_epoch, cuda_mf_epoch, "mf_fullbatch_train",
                           lambda make: (make(5), make(5), make(5), make(3, 4), make(6, 4), 2,
                                         0.01)),
    "lr_fullbatch_train": (lr_epoch, cuda_lr_epoch, "lr_fullbatch_train",
                           lambda make: (make(5, 8), make(5), make(8, 1), 2, 0.05)),
    "lr_fullbatch_train_compact": (lr_epoch, cuda_lr_epoch, "lr_fullbatch_train_compact",
                                   lambda make: (make(5), make(5), make(5, 4), make(5),
                                                 make(1, 11), 2, 0.05, 3, 4)),
    "afm_attention_pool": (afm_attention, cuda_afm, "afm_attention_pool",
                           lambda make: (make(5, 6, 8), make(8, 4), make(4), make(4, 1))),
    "afm_attention_pool_bwd": (afm_attention, cuda_afm, "afm_attention_pool_bwd",
                               lambda make: (make(5, 6, 8), make(8, 4), make(4), make(4, 1),
                                             make(5, 8))),
    "din_head_fwd": (din_head, cuda_din_head, "din_head_fused",
                     lambda make: (make(5, 3, 8), make(5, 8), _din_weights(make))),
    "din_head_bwd": (din_head, cuda_din_head, "din_head_fused_bwd",
                     lambda make: (make(5, 3, 8), make(5, 8), _din_weights(make), make(5))),
    "din_attention_pool": (din_attention, cuda_din_attention, "din_attention_pool",
                           lambda make: (make(5, 3, 8), make(5, 8), _din_att(make))),
}
FLOAT_ONLY = ("lr_fullbatch_train", "afm_attention_pool", "afm_attention_pool_bwd",
              "din_head_fwd", "din_head_bwd", "din_attention_pool")


def _din_weights(make, D=8, A1=4, A2=4, F1=4, F2=4):
    """The 14 DIN head weights (ops/din_head.py::din_head_weights' shapes)."""
    shapes = [(D, A1), (D, A1), (1, A1), (A1, A2), (1, A2), (A2, 1), (1, 1),
              (D, F1), (D, F1), (1, F1), (F1, F2), (1, F2), (F2, 1), (1, 1)]
    return tuple(make(*shape) for shape in shapes)


def _din_att(make, D=8, A1=4, A2=4):
    """An attention MLP 3D -> A1 -> A2 -> 1."""
    return [{"w": make(3 * D, A1), "b": make(A1)}, {"w": make(A1, A2), "b": make(A2)},
            {"w": make(A2, 1), "b": make(1)}]


def _int_or(make):
    """Ids must be integer tensors for the plain versions."""
    def build(*shape):
        return make(*shape, dtype=torch.int64) if len(shape) == 1 else make(*shape)
    return build


def _cpu_args(name):
    if name in FLOAT_ONLY:  # no ids among the arguments
        return TRAIN_WRAPPERS[name][3](torch.zeros)
    args = TRAIN_WRAPPERS[name][3](_int_or(torch.zeros))
    if name == "mf_fullbatch_train":  # labels are float
        return (args[0], args[1], torch.zeros(5)) + args[3:]
    if name == "lr_fullbatch_train_compact":
        return args[:3] + (torch.zeros(5),) + args[4:]
    return args


@pytest.mark.parametrize("name", list(TRAIN_WRAPPERS))
def test_train_cuda_tensors_go_to_the_launcher(monkeypatch, name):
    module, launchers, launcher, make_args = TRAIN_WRAPPERS[name]
    calls = []
    monkeypatch.setattr(module, f"{name}_plain", _never)
    monkeypatch.setattr(launchers, launcher, lambda *a, **k: calls.append(len(a)) or "launched")
    args = make_args(lambda *shape, **kw: _fake_cuda(*shape))
    assert getattr(module, name)(*args) == "launched"
    assert len(calls) == 1


@pytest.mark.parametrize("name", list(TRAIN_WRAPPERS))
def test_train_cpu_tensors_take_the_plain_version(monkeypatch, name):
    module, launchers, launcher, _ = TRAIN_WRAPPERS[name]
    monkeypatch.setattr(launchers, launcher, _never)
    out = getattr(module, name)(*_cpu_args(name))
    assert out is not None


@pytest.mark.parametrize("name", list(TRAIN_WRAPPERS))
def test_train_launchers_reject_cpu_tensors(name):
    _, launchers, launcher, _ = TRAIN_WRAPPERS[name]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(launchers, launcher)(*_cpu_args(name))


@pytest.mark.parametrize("module", [gather, mf_epoch, lr_epoch, afm_attention, din_head,
                                    din_attention],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_train_wrapper_sources_have_no_fallback(module):
    """As for the top-k wrappers: no ``try``; the plain version is called once,
    inside ``if _on_cpu(...)``; the launcher modules call no plain version."""
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    names = [n for n in TRAIN_WRAPPERS if TRAIN_WRAPPERS[n][0] is module]
    assert names
    for name in names:
        fn = funcs[name]
        assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
        (branch,) = [n for n in fn.body if isinstance(n, ast.If)]
        assert _calls(branch.test) == ["_on_cpu"]
        plain = [c for c in _calls(fn) if c.endswith("_plain")]
        assert plain == [f"{name}_plain"] == [c for c in _calls(branch) if c.endswith("_plain")]
    for launchers in (cuda_gather, cuda_mf_epoch, cuda_lr_epoch, cuda_afm, cuda_din_head,
                      cuda_din_attention, cuda_sparse_rows):
        text = pathlib.Path(launchers.__file__).read_text()
        assert "_plain" not in text and "try:" not in text


# ---- the row-sparse update's kernels: the dedup and row-wise AdaGrad

def _fake_cuda_rows(*shape, dtype=torch.float32):
    """A CUDA tensor where there is no card, as ``train/sparse.py`` reads it
    before it hands it on: device, dtype, shape and contiguity."""
    return types.SimpleNamespace(device=torch.device("cuda"), dtype=dtype,
                                 shape=torch.Size(shape), is_contiguous=lambda: True)


SPARSE_KERNELS = {
    # the function of train/sparse.py, its arguments given a tensor maker and a
    # row width
    "dedup_rows": lambda make, D: (make(6, dtype=torch.int64), make(6, D), 9),
    "rowwise_adagrad": lambda make, D: (make(9, D), types.SimpleNamespace(accum=make(9)),
                                        make(6, dtype=torch.int64), make(6, D), 0.1, 1e-10),
}


def _cpu_sparse_args(name):
    if name == "dedup_rows":
        return torch.tensor([3, 1, 3, 9, 0, 1]), torch.randn(6, 4), 9
    from deeplearningrecommendationsystem_tpu_torch.train import sparse

    return (torch.randn(9, 4), RowwiseAdagradState.init(9, device="cpu"),
            *sparse.dedup_rows_plain(torch.tensor([3, 1, 3, 9, 0, 1]), torch.randn(6, 4), 9),
            0.1, 1e-10)


# a bias table's one column, and a few
@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("name", list(SPARSE_KERNELS))
def test_sparse_cuda_rows_go_to_the_launcher(monkeypatch, name, D):
    from deeplearningrecommendationsystem_tpu_torch.train import sparse

    calls = []
    monkeypatch.setattr(sparse, f"{name}_plain", _never)
    monkeypatch.setattr(cuda_sparse_rows, name, lambda *a: calls.append(a) or ("launched", a))
    args = SPARSE_KERNELS[name](_fake_cuda_rows, D)
    out = getattr(sparse, name)(*args)
    assert len(calls) == 1
    if name == "dedup_rows":
        assert out == ("launched", args)
    else:  # the launcher takes the state's accumulator and updates in place
        table, state, uids, ugrads, lr, eps = args
        assert calls[0] == (table, state.accum, uids, ugrads, lr, eps)
        assert out == (table, state)


@pytest.mark.parametrize("name", list(SPARSE_KERNELS))
def test_sparse_cpu_rows_take_the_plain_version(monkeypatch, name):
    from deeplearningrecommendationsystem_tpu_torch.train import sparse

    monkeypatch.setattr(cuda_sparse_rows, name, _never)
    assert getattr(sparse, name)(*_cpu_sparse_args(name)) is not None


@pytest.mark.parametrize("name", list(SPARSE_KERNELS))
def test_sparse_launchers_reject_cpu_tensors(name):
    args = _cpu_sparse_args(name)
    if name == "rowwise_adagrad":  # the launcher takes the accumulator, not the state
        args = (args[0], args[1].accum, *args[2:])
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cuda_sparse_rows, name)(*args)


def test_sparse_source_has_no_fallback():
    """``dedup_rows`` and ``rowwise_adagrad``: no ``try``; the launcher is
    called once, inside ``if _on_kernels(...)``, and the plain version after
    it, outside."""
    from deeplearningrecommendationsystem_tpu_torch.train import sparse

    tree = ast.parse(pathlib.Path(sparse.__file__).read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    for name in SPARSE_KERNELS:
        fn = funcs[name]
        assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
        (branch,) = [n for n in fn.body if isinstance(n, ast.If)]
        assert _calls(branch.test) == ["_on_kernels"]
        launched = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute) and n.func.attr == name]
        assert len(launched) == 1 and launched[0] in list(ast.walk(branch))
        assert f"{name}_plain" in _calls(fn) and f"{name}_plain" not in _calls(branch)


def test_gather_rows_goes_through_the_kernel_pair(monkeypatch):
    """The embedding lookup's forward and backward are the two wrappers."""
    from deeplearningrecommendationsystem_tpu_torch.ops import embedding

    seen = []
    monkeypatch.setattr(embedding, "gather_rows_kernel",
                        lambda t, i: seen.append("fwd") or gather.gather_rows_kernel_plain(t, i))
    monkeypatch.setattr(embedding, "onehot_grad",
                        lambda i, g, v: seen.append("bwd") or gather.onehot_grad_plain(i, g, v))
    table = torch.randn(6, 3, requires_grad=True)
    embedding.gather_rows(table, torch.tensor([[1, 5], [0, 1]])).sum().backward()
    assert seen == ["fwd", "bwd"]
    np.testing.assert_array_equal(table.grad[:, 0].numpy(), [1, 2, 0, 0, 0, 1])


def test_afm_pool_goes_through_the_kernel_pair(monkeypatch):
    """AFM's forward takes the pool wrapper, its backward the backward wrapper."""
    seen = []
    monkeypatch.setattr(afm_attention, "afm_attention_pool", lambda *a: seen.append("fwd") or
                        afm_attention.afm_attention_pool_plain(*a))
    monkeypatch.setattr(afm_attention, "afm_attention_pool_bwd", lambda *a: seen.append("bwd") or
                        afm_attention.afm_attention_pool_bwd_plain(*a))
    spec = FeatureSpec(num_users=4, num_items=5)
    model = AFM(spec, 8, 4, device="cpu")
    x = torch.zeros((3, 45))
    x[:, 0], x[:, 1] = torch.tensor([0.0, 1, 3]), torch.tensor([4.0, 2, 0])
    model(x).sum().backward()
    assert seen == ["fwd", "bwd"]
    assert model.att_w.grad is not None and model.tables.user.grad is not None


# the feature models ported with DeepFM, narrow, and their lookups a forward:
# the two id tables, and the two bias tables of a linear part; FFM's two
# domains of each id table
FEATURE_MODELS = {
    "DeepFM": (lambda spec: DeepFM(spec, (8, 4, 1), 8, device="cpu"), 4),
    "WideDeep": (lambda spec: WideDeep(spec, (8, 4, 1), 8, device="cpu"), 4),
    "NFM": (lambda spec: NFM(spec, (8, 4, 1), 8, device="cpu"), 4),
    "PNN": (lambda spec: PNN(spec, 8, (8, 4), device="cpu"), 2),
    "DCN": (lambda spec: DCN(spec, 2, (8, 4, 1), 8, device="cpu"), 2),
    "DeepCrossing": (lambda spec: DeepCrossing(spec, 8, (8, 4), device="cpu"), 2),
    "FFM": (lambda spec: FFM(spec, 8, device="cpu"), 6),
}


@pytest.mark.parametrize("name", list(FEATURE_MODELS))
def test_feature_model_lookups_go_through_the_kernel_pair(monkeypatch, name):
    """Every id lookup of the model's forward takes the gather wrapper, and its
    backward the onehot_grad wrapper, whose CUDA route is the launcher (above);
    the lookups a forward are the count chip_smoke.py holds."""
    from deeplearningrecommendationsystem_tpu_torch.ops import embedding

    seen = []
    monkeypatch.setattr(embedding, "gather_rows_kernel",
                        lambda t, i: seen.append("fwd") or gather.gather_rows_kernel_plain(t, i))
    monkeypatch.setattr(embedding, "onehot_grad",
                        lambda i, g, v: seen.append("bwd") or gather.onehot_grad_plain(i, g, v))
    make, lookups = FEATURE_MODELS[name]
    model = make(FeatureSpec(num_users=4, num_items=5))
    x = torch.zeros((3, 45))
    x[:, 0], x[:, 1], x[:, 2] = torch.tensor([0.0, 1, 3]), torch.tensor([4.0, 2, 0]), 0.5
    model(x).sum().backward()
    assert seen == ["fwd"] * lookups + ["bwd"] * lookups
    with torch.no_grad():
        scores = model.score_catalog(ServingContext(torch.zeros((4, 24)), torch.zeros((5, 19))))
    assert scores.shape == (4, 5) and seen.count("fwd") == 2 * lookups


@pytest.mark.parametrize("mode", ["compact", "wide"])
def test_lr_fast_fit_goes_through_its_wrapper(monkeypatch, mode):
    name = {"compact": "lr_fullbatch_train_compact", "wide": "lr_fullbatch_train"}[mode]
    from deeplearningrecommendationsystem_tpu_torch.models import lr as lr_model

    calls = []
    plain = getattr(lr_epoch, f"{name}_plain")
    monkeypatch.setattr(lr_model, name, lambda *a, **k: calls.append(name) or plain(*a, **k))
    model = LogisticRegression(FeatureSpec(num_users=4, num_items=5), device="cpu")
    x = torch.zeros((3, 45))
    x[:, 0], x[:, 1] = torch.tensor([0.0, 1, 3]), torch.tensor([4.0, 2, 0])
    params, losses = model.fast_fit(model.params(), x, torch.ones(3), 2, 0.05, mode=mode)
    assert calls == [name] and losses.shape == (2,)
    assert params.keys() == model.params().keys()


def _din_batch():
    hist = torch.tensor([[0, 0, 3, 5], [1, 2, 3, 4], [0, 6, 0, 2]])
    return hist, torch.tensor([4, 0, 6])


@pytest.mark.parametrize("route", ["train", "window", "masked", "full_history"])
def test_din_routes(monkeypatch, route):
    """Unmasked training and evaluation take the DIN head wrappers (forward,
    then backward), the window catalog scorer the attention pool, and the
    masked routes neither: no kernel takes a mask."""
    seen = []
    for name in ("din_head_fwd", "din_head_bwd"):
        plain = getattr(din_head, f"{name}_plain")
        monkeypatch.setattr(din_head, name, lambda *a, _n=name, _p=plain: seen.append(_n) or _p(*a))
    from deeplearningrecommendationsystem_tpu_torch.models import din as din_model

    monkeypatch.setattr(din_model, "din_attention_pool", lambda *a: seen.append("pool") or
                        din_attention.din_attention_pool_plain(*a))
    kw = dict(embed_size=8, attention_units=(4, 4, 1), fc_units=(4, 4, 1), device="cpu")
    model = DIN(7, mask_padding=route == "masked", **kw)
    if route in ("train", "masked"):
        model(_din_batch()).sum().backward()
        assert model.att[0].w.grad is not None and model.item.grad is not None
        assert seen == (["din_head_fwd", "din_head_bwd"] if route == "train" else [])
        return
    hist = _din_batch()[0]
    ctx = ServingContext(torch.zeros((3, 24)), torch.zeros((7, 19)), history=hist,
                         full_histories=[h.numpy() for h in hist] if route == "full_history"
                         else None)
    with torch.no_grad():
        scores = model.score_catalog(ctx)
    assert scores.shape == (3, 7)
    assert seen == (["pool"] if route == "window" else [])


def _lookups(monkeypatch):
    from deeplearningrecommendationsystem_tpu_torch.ops import embedding

    seen = []
    monkeypatch.setattr(embedding, "gather_rows_kernel",
                        lambda t, i: seen.append("fwd") or gather.gather_rows_kernel_plain(t, i))
    monkeypatch.setattr(embedding, "onehot_grad",
                        lambda i, g, v: seen.append("bwd") or gather.onehot_grad_plain(i, g, v))
    for name in ("din_head_fwd", "din_head_bwd"):
        monkeypatch.setattr(din_head, name, lambda *a, _n=name: seen.append(_n))
    monkeypatch.setattr(din_attention, "din_attention_pool", lambda *a: seen.append("pool"))
    return seen


@pytest.mark.parametrize("use_augru", [False, True], ids=["parity", "augru"])
def test_dien_lookups_go_through_the_kernel_pair(monkeypatch, use_augru):
    """DIEN's history and target lookups (and its auxiliary negatives') take
    the gather wrapper, their gradients onehot_grad; no DIN head or pool."""
    seen = _lookups(monkeypatch)
    model = DIEN(7, 8, (4, 4, 1), (4, 4, 1), use_augru=use_augru, device="cpu")
    hist, target = _din_batch()
    model((hist, target)).sum().backward()
    assert seen == ["fwd", "fwd", "bwd", "bwd"]
    logits, aux = model.apply_with_aux(model.params(), (hist, target, hist.flip(1)))
    (logits.sum() + aux).backward()
    assert seen[4:] == ["fwd", "fwd", "fwd", "bwd", "bwd", "bwd"]
    with torch.no_grad():
        scores = model.score_catalog(ServingContext(torch.zeros((3, 24)), torch.zeros((7, 19)),
                                                    full_histories=[h.numpy() for h in hist]))
    assert scores.shape == (3, 7) and "pool" not in seen and "din_head_fwd" not in seen


def test_neuralcf_and_autorec_lookups(monkeypatch):
    """NeuralCF: four lookups a forward through the gather pair; the catalog
    through the same. AutoRec: none."""
    seen = _lookups(monkeypatch)
    model = NeuralCF(4, 6, 8, (8, 4), device="cpu")
    model((torch.tensor([0, 3, 1]), torch.tensor([5, 0, 2]))).sum().backward()
    assert seen == ["fwd"] * 4 + ["bwd"] * 4
    with torch.no_grad():
        assert model.score_catalog(ServingContext(torch.zeros((4, 24)),
                                                  torch.zeros((6, 19)))).shape == (4, 6)
    assert seen.count("fwd") == 8  # one 64-user tile
    del seen[:]
    auto = AutoRec(6, 4, device="cpu")
    auto(torch.full((4, 6), 0.5)).sum().backward()
    assert seen == []


# ---- the training modes and classic CF

def _feature_batch(n=6):
    x = torch.zeros((n, 45))
    x[:, 0], x[:, 1], x[:, 2] = torch.arange(n) % 4, torch.arange(n) % 5, 0.5
    return x, (torch.arange(n) % 2).float()


@pytest.mark.parametrize("mode", ["minibatch", "stream"])
def test_minibatch_lookups_go_through_the_kernel_pair(monkeypatch, mode):
    """Each step's lookups take the gather wrapper and their gradients the
    onehot_grad wrapper (MF: two tables a step)."""
    seen = _lookups(monkeypatch)
    trainer = Trainer(MatrixFactorization(4, 6, 8, device="cpu"), TrainConfig(epochs=2),
                      device="cpu")
    ids = torch.tensor([0, 3, 1, 2, 3, 0])
    train = ((ids, ids % 6), torch.ones(6))
    if mode == "minibatch":
        fit_minibatch(trainer, 0, train, 3)
    else:
        fit_stream(trainer, 0, ((ids.numpy(), ids.numpy() % 6), np.ones(6, np.float32)), 3)
    assert seen == ["fwd", "fwd", "bwd", "bwd"] * 4  # 2 epochs x 2 steps


@pytest.mark.parametrize("model", ["mf", "deepfm"])
@pytest.mark.parametrize("source", ["minibatch", "stream"])
def test_sparse_trainer_gathers_rows_through_the_wrapper(monkeypatch, model, source):
    """The table rows come through the gather wrapper (MF 2 tables, DeepFM 4)
    and no table gradient is formed: no onehot_grad."""
    seen = _lookups(monkeypatch)
    if model == "mf":
        net, tables = MatrixFactorization(4, 6, 8, device="cpu"), 2
        ids = torch.tensor([0, 3, 1, 2, 3, 0])
        train = ((ids, ids % 6), torch.ones(6))
    else:
        net, tables = DeepFM(FeatureSpec(num_users=4, num_items=5), (8, 4, 1), 8,
                             device="cpu"), 4
        train = _feature_batch()
    trainer = Trainer(net, TrainConfig(epochs=2), device="cpu")
    if source == "minibatch":
        fit_minibatch_sparse(trainer, 0, train, 3)
    else:
        host = (tuple(t.numpy() for t in train[0]) if isinstance(train[0], tuple)
                else train[0].numpy(), train[1].numpy())
        fit_stream_sparse(trainer, 0, host, 3)
    assert seen == ["fwd"] * tables * 4


def _topk_calls(monkeypatch):
    from deeplearningrecommendationsystem_tpu_torch.cf import gdcf, neighborhood

    calls = []

    def record(scores, seen, k=50):
        calls.append((tuple(scores.shape), seen.clone(), k))
        return topk.topk_scores_plain(scores, seen, k)

    for module in (neighborhood, gdcf):
        monkeypatch.setattr(module, "topk_scores", record)
    return calls


@pytest.mark.parametrize("algo", ["usercf", "itemcf"])
def test_neighbourhood_cf_topk_goes_through_topk_scores(monkeypatch, algo):
    """Two top-k: the neighbours' (the identity masked) and the
    recommendations' (the rated items masked)."""
    calls = _topk_calls(monkeypatch)
    m = (np.random.default_rng(0).random((7, 9)) < 0.3).astype(np.float32)
    fn = cf.user_cf_recommend if algo == "usercf" else cf.item_cf_recommend
    rec = fn(m, k_neighbors=3, top_n=4, device="cpu")
    n = 7 if algo == "usercf" else 9
    assert [(c[0], c[2]) for c in calls] == [((n, n), 3), ((7, 9), 4)]
    assert torch.equal(calls[0][1], torch.eye(n, dtype=torch.bool))
    assert torch.equal(calls[1][1], torch.from_numpy(m > 0))
    assert rec.shape == (7, 4)


@pytest.mark.parametrize("exclude_rated", [False, True])
def test_gdcf_topk_goes_through_topk_scores(monkeypatch, exclude_rated):
    calls = _topk_calls(monkeypatch)
    m = (np.random.default_rng(0).random((7, 9)) < 0.3).astype(np.float32)
    cf.gdcf_train(m, embedding_size=4, iterations=3, top_k=5, exclude_rated=exclude_rated,
                  device="cpu")
    assert [(c[0], c[2]) for c in calls] == [((7, 9), 5)] * 3
    want = torch.from_numpy(m > 0) if exclude_rated else torch.zeros((7, 9), dtype=torch.bool)
    assert all(torch.equal(c[1], want) for c in calls)


def test_cf_sources_take_no_other_top_k():
    """No stable_top_k, sort or library top-k in the CF modules: on a CUDA
    tensor every top-k is the topk_scores kernel (its wrapper's dispatch is
    held above)."""
    for name in ("neighborhood.py", "gdcf.py"):
        tree = ast.parse((PACKAGE / "cf" / name).read_text())
        called = {n.func.attr if isinstance(n.func, ast.Attribute) else getattr(n.func, "id", "")
                  for n in ast.walk(tree) if isinstance(n, ast.Call)}
        assert not called & {"stable_top_k", "topk", "sort", "argsort", "top_k"}, name
        assert "topk_scores" in called


@pytest.mark.cuda
def test_pinned_prefetch_on_the_card(cuda):
    """Every batch arrives whole and in order through the pinned side-stream
    copy, with the consumer writing over what it was handed in between."""
    rng = np.random.default_rng(1)
    arrays = (rng.integers(0, 1000, 50_000), rng.random((50_000, 8)).astype(np.float32))
    loader = StreamingLoader(arrays, 4096, seed=2, prefetch=3, device=cuda)
    want = list(StreamingLoader(arrays, 4096, seed=2, device="cpu").epoch())
    got = 0
    for (gi, gx), (wi, wx) in zip(loader.epoch(), want):
        assert gi.device.type == "cuda" and gx.is_contiguous()
        torch.testing.assert_close(gi.cpu(), wi, rtol=0, atol=0)
        torch.testing.assert_close(gx.cpu(), wx, rtol=0, atol=0)
        gx.mul_(0.0)  # the consumer's stream writes on the batch it was handed
        got += 1
    torch.cuda.synchronize()
    assert got == len(want) == 50_000 // 4096


@pytest.mark.cuda
def test_cf_launches_the_topk_kernel(cuda):
    m = (np.random.default_rng(0).random((40, 60)) < 0.2).astype(np.float32)
    before = cuda_topk.topk_scores.launches
    rec = cf.user_cf_recommend(m, k_neighbors=5, top_n=10, device=cuda)
    torch.cuda.synchronize()
    assert cuda_topk.topk_scores.launches == before + 2
    want = cf.user_cf_recommend(m, k_neighbors=5, top_n=10, device="cpu")
    assert rec.shape == want.shape == (40, 10)


# ---- the parallel layer

def test_local_device_follows_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_device() == torch.device("cuda:3")
    monkeypatch.delenv("LOCAL_RANK")
    assert distributed.local_device() == torch.device("cuda:0")
    assert distributed.local_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.local_device()
    assert distributed.local_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("backend, device, stages", [
    ("nccl", "cuda", False), ("gloo", "cpu", False), ("gloo", "cuda", True),
    ("nccl", "cpu", None), ("mpi", "cpu", None), ("gloo", "meta", None)])
def test_collectives_never_switch_transport(monkeypatch, backend, device, stages):
    """NCCL moves CUDA tensors, Gloo CPU tensors and (staged through the host)
    CUDA tensors; every other pair raises, and a sum over more than one rank
    with such a pair raises before any transport is touched."""
    monkeypatch.setattr(collectives.dist, "get_backend", lambda group=None: backend)
    t = types.SimpleNamespace(device=torch.device(device))
    if stages is None:
        with pytest.raises(RuntimeError, match="no transport"):
            collectives._stages(None, t)
        monkeypatch.setattr(collectives, "group_size", lambda group: 2)
        monkeypatch.setattr(collectives.dist, "all_reduce", _never)
        with pytest.raises(RuntimeError, match="no transport"):
            collectives.sum_over(torch.ones(3, device=device if device != "cuda" else "cpu"),
                                 None)
    else:
        assert collectives._stages(None, t) is stages


def test_collectives_source_has_no_switch():
    """The transport is the group's: the module never picks a backend, never
    opens a group, and never moves a tensor to another device but the
    staging copy of Gloo."""
    src = (PACKAGE / "parallel" / "collectives.py").read_text()
    for banned in ("init_process_group(", "new_group(", "set_device(", ".to(\"cpu", "cuda()"):
        assert banned not in src, banned
    assert src.count(".cpu()") == 1  # the staging copy


def test_ep_lookups_and_sharded_topk_go_through_the_wrappers():
    import torch_ranks

    rng = np.random.default_rng(0)
    table = rng.standard_normal((13, 4)).astype(np.float32)
    ids = rng.integers(0, 13, 8)
    out = distributed.spawn(torch_ranks.lookup_rank, 2,
                            args=(table, ids, np.ones((8, 4), np.float32), (7,)),
                            deadline_s=120.0)
    for o in out:
        for strategy in ("psum", "scatter"):
            assert o[strategy]["calls"] == {"gather_rows": 1, "onehot_grad": 1,
                                            "topk_serve_matmul": 0, "topk_scores": 0}
    P, Q = rng.standard_normal((5, 4)).astype(np.float32), table
    out = distributed.spawn(torch_ranks.serving_rank, 2,
                            args=([dict(name="topk", op="topk", P=P, Q=Q, k=3)],),
                            deadline_s=120.0)
    for o in out:
        assert o["topk"]["calls"] == {"gather_rows": 0, "onehot_grad": 0,
                                      "topk_serve_matmul": 1, "topk_scores": 1}
