"""The port stands alone, and its device rule holds.

* No file of ``deeplearningrecommendationsystem_tpu_torch`` and not
  ``chip_smoke.py`` imports ``jax``, ``jaxlib`` or the JAX package.
* Entry points default to CUDA and raise where it is absent, unless the caller
  passes ``device="cpu"``.
* A CUDA tensor given to a kernel wrapper (top-k, gather, onehot_grad, the
  fused MF trainer) goes to its kernel launcher and never to the plain
  version; there is no fallback.

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

from deeplearningrecommendationsystem_tpu_torch import experiments
from deeplearningrecommendationsystem_tpu_torch.cli import serve
from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.device import resolve_device
from deeplearningrecommendationsystem_tpu_torch.models import MatrixFactorization, ServingContext
from deeplearningrecommendationsystem_tpu_torch.ops import gather, mf_epoch
from deeplearningrecommendationsystem_tpu_torch.ops import serving_topk as topk
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import gather as cuda_gather
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import mf_epoch as cuda_mf_epoch
from deeplearningrecommendationsystem_tpu_torch.ops.cuda import serving_topk as cuda_topk
from deeplearningrecommendationsystem_tpu_torch.sampling import NegativeSampler
from deeplearningrecommendationsystem_tpu_torch.serving import Recommender
from deeplearningrecommendationsystem_tpu_torch.train import TrainConfig, Trainer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "deeplearningrecommendationsystem_tpu_torch"
PORT_FILES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
            "deeplearningrecommendationsystem_tpu_torch/train/trainer.py",
            "deeplearningrecommendationsystem_tpu_torch/experiments.py",
            "deeplearningrecommendationsystem_tpu_torch/cli/serve.py"} <= names


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
    "Recommender": lambda: Recommender(MatrixFactorization(4, 6, 8, device="cpu"), _ctx()),
    "Trainer": lambda: Trainer(MatrixFactorization(4, 6, 8, device="cpu"), TrainConfig()),
    "NegativeSampler": lambda: NegativeSampler(np.zeros((4, 6), dtype=bool), seed=0),
    "run_experiment": lambda: experiments.run_experiment(PRESETS["mf"], data_path="unused"),
    "build_server": lambda: serve.build_server(
        serve.parser().parse_args(["--model", "mf", "--data", "unused"])),
}


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
}


def _int_or(make):
    """Ids must be integer tensors for the plain versions."""
    def build(*shape):
        return make(*shape, dtype=torch.int64) if len(shape) == 1 else make(*shape)
    return build


def _cpu_args(name):
    args = TRAIN_WRAPPERS[name][3](_int_or(torch.zeros))
    if name == "mf_fullbatch_train":  # labels are float
        return (args[0], args[1], torch.zeros(5)) + args[3:]
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


@pytest.mark.parametrize("module", [gather, mf_epoch], ids=lambda m: m.__name__.rsplit(".", 1)[1])
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
    for launchers in (cuda_gather, cuda_mf_epoch):
        text = pathlib.Path(launchers.__file__).read_text()
        assert "_plain" not in text and "try:" not in text


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
