"""The port's ``cli/run.py``, as ``tests/test_cli.py`` drives the JAX one, on
a small synthetic ml-100k-format dataset (60 users, 300 items) on the CPU:
``--list``; a one-epoch ``--json`` run of every preset; bf16 with ``--plot``;
the minibatch, stream and sparse training modes; ``--mesh`` outside
``torchrun``;
``--plot`` without matplotlib; and
``runtime/logging.py::print_report``'s text against the JAX package's for
the same result.
"""

import builtins
import io
import json
import contextlib

import numpy as np
import pytest
import torch

from deeplearningrecommendationsystem_tpu.runtime.logging import print_report as jax_print_report
from deeplearningrecommendationsystem_tpu_torch.cli.run import main
from deeplearningrecommendationsystem_tpu_torch.configs import PRESETS
from deeplearningrecommendationsystem_tpu_torch.data import write_ml100k_format
from deeplearningrecommendationsystem_tpu_torch.experiments import ExperimentResult
from deeplearningrecommendationsystem_tpu_torch.runtime.logging import print_report


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: these tests run many small ops (DIEN's GRU
    steps), for which threads buy nothing alone and, with several test
    workers on one host, each worker's thread pool spinning against the
    others' made them ten times slower."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return write_ml100k_format(str(tmp_path_factory.mktemp("mlc")), seed=5, num_users=60,
                               num_items=300, num_ratings=3000)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_list(capsys):
    assert main(["--list"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(PRESETS) == 15
    assert [line.split()[0] for line in lines] == sorted(PRESETS)
    assert "family=matrix" in lines[sorted(PRESETS).index("i-autorec")]


@pytest.mark.parametrize("model", sorted(PRESETS))
def test_tiny_run_json(data_dir, model, capsys):
    assert main(["--model", model, "--epochs", "1", "--json", "--device", "cpu",
                 "--data", data_dir, "--seed", "1"]) == 0
    payload = _last_json(capsys)
    assert payload["model"] == model
    assert "test_auc" in payload["final"] and np.isfinite(payload["final"]["train_loss"])
    assert set(payload["ranking"]) == {"valid", "valid@10", "test", "test@10"}
    assert payload["examples_per_sec"] > 0 and payload["train_time_s"] > 0


def test_dien_extensions(data_dir, capsys):
    assert main(["--model", "dien", "--epochs", "1", "--json", "--device", "cpu", "--data",
                 data_dir, "--augru", "--aux-weight", "0.5", "--fast-gathers"]) == 0
    assert _last_json(capsys)["model"] == "dien"
    with pytest.raises(SystemExit):
        main(["--model", "mf", "--augru", "--device", "cpu", "--data", data_dir])


def test_verbose_report(data_dir, capsys):
    assert main(["--model", "autorec", "--epochs", "2", "--device", "cpu", "--data",
                 data_dir]) == 0
    out = capsys.readouterr().out
    assert "Epoch 2:" in out and "Test ranking metrics:" in out and "[autorec]" in out


def test_tiny_run_bf16_and_plot(data_dir, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out_png = tmp_path / "curves.png"
    assert main(["--model", "mf", "--epochs", "2", "--json", "--device", "cpu", "--data",
                 data_dir, "--compute-dtype", "bfloat16", "--plot", str(out_png)]) == 0
    assert _last_json(capsys)["model"] == "mf"
    assert out_png.exists() and out_png.stat().st_size > 0


def test_plot_without_matplotlib_fails_before_training(data_dir, tmp_path, monkeypatch):
    """A machine without matplotlib: ``--plot`` raises a clear ImportError
    before any training, and skips nothing silently."""
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    import deeplearningrecommendationsystem_tpu_torch.cli.run as run_module

    def never(*a, **k):
        raise AssertionError("trained before the plot's dependency was checked")

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    monkeypatch.setattr(run_module, "run_experiment", never)
    with pytest.raises(ImportError, match="matplotlib"):
        main(["--model", "mf", "--epochs", "1", "--device", "cpu", "--data", data_dir,
              "--plot", str(tmp_path / "x.png")])


@pytest.mark.parametrize("flags, item", [(["--train-mode", "sparse", "--mesh", "1,2"],
                                          "no process group"),
                                         (["--train-mode", "minibatch", "--mesh", "1,2"],
                                          "no process group"),
                                         (["--mesh", "1,2"], "no process group")],
                         ids=["sparse", "minibatch", "mesh"])
def test_unported_flags_exit_naming_their_item(data_dir, flags, item):
    """Every training mode runs (``test_train_modes``); ``--mesh``, in any
    mode, runs only under ``torchrun`` (its ranks: ``tests/test_torch_runtime.py``)
    and exits with a message in one process."""
    with pytest.raises(SystemExit, match=item):
        main(["--model", "mf", "--epochs", "1", "--device", "cpu", "--data", data_dir] + flags)


@pytest.mark.parametrize("model, flags", [
    ("mf", ["--train-mode", "sparse"]),
    ("mf", ["--train-mode", "sparse", "--sparse-optimizer", "rowwise_adagrad"]),
    ("deepfm", ["--train-mode", "sparse"]),
    ("mf", ["--train-mode", "minibatch"]),
    ("din", ["--train-mode", "minibatch"]),
    ("deepfm", ["--train-mode", "stream"]),
], ids=["mf_sparse", "mf_sparse_adagrad", "deepfm_sparse", "mf_minibatch", "din_minibatch",
        "deepfm_stream"])
def test_train_modes(data_dir, model, flags, capsys):
    """The minibatch modes through the CLI: the JSON summary's final metrics
    are the last epoch's train loss alone, the ranking is there, and the text
    report prints the other metrics as nan, as the JAX report does."""
    argv = ["--model", model, "--epochs", "2", "--device", "cpu", "--data", data_dir,
            "--batch-size", "1024"] + flags
    assert main(argv + ["--json"]) == 0
    payload = _last_json(capsys)
    assert set(payload["final"]) == {"train_loss"} and np.isfinite(payload["final"]["train_loss"])
    assert set(payload["ranking"]) == {"valid", "valid@10", "test", "test@10"}
    assert main(argv) == 0
    out = capsys.readouterr().out
    assert "- Training Loss: " in out and "- Valid Loss: nan" in out and "Test ranking" in out


def test_model_is_required():
    with pytest.raises(SystemExit):
        main([])


def _result():
    rng = np.random.default_rng(0)
    keys = [f"{s}_{m}" for s in ("train", "valid", "test")
            for m in ("loss", "accuracy", "precision", "recall", "f1", "auc")]
    history = {k: rng.random(4).astype(np.float32) for k in keys}
    history["_param_checksum"] = np.array([1.5], np.float32)
    ranking = {s: {m: float(rng.random()) for m in ("precision", "recall", "f1", "map",
                                                    "ndcg", "mrr")}
               for s in ("valid", "test", "valid@10", "test@10")}
    return ExperimentResult(model="dien", params={}, history=history, ranking=ranking,
                            train_examples=87_900, epochs=4, train_time_s=1.25)


@pytest.mark.parametrize("k, stride", [(50, 0), (10, 2)])
def test_print_report_text_equals_jax(k, stride):
    res = _result()
    outs = []
    for fn in (print_report, jax_print_report):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(res, k=k, epoch_stride=stride)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert f"Precision@{k}" in outs[0] and "87900 examples x 4 epochs in 1.25s" in outs[0]


def test_print_report_of_a_minibatch_history_equals_jax():
    """A minibatch mode's history holds only ``train_loss``: the other
    metrics print as nan, as in the JAX report."""
    res = _result()
    res.history = {"train_loss": res.history["train_loss"]}
    outs = []
    for fn in (print_report, jax_print_report):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(res, k=50)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and "- Valid Loss: nan" in outs[0]
