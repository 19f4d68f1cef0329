"""Training-curve figures (the reference's only visualisation surface).

The JAX package's ``runtime/plotting.py``: the reference renders one figure,
GDCF_Final.py:99-117, Precision/Recall/F1 against the epoch beside the loss
against the epoch. ``plot_history`` draws it from any metric history (an
``ExperimentResult.history`` of arrays, or ``TrainResult.history`` of
tensors, on any device), loss curves in the right panel and the rest on the
left, and saves it to a file.

matplotlib is optional and imported only when a figure is asked for:
``require_matplotlib`` raises an ``ImportError`` that says so, which
``cli/run.py --plot`` calls before it trains.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch


def require_matplotlib():
    """``matplotlib.pyplot`` on the Agg backend; an ``ImportError`` naming the
    missing optional dependency where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "plot_history needs matplotlib (optional dependency), which is not installed"
        ) from e
    return plt


def plot_history(
    history: Dict[str, "np.ndarray"],
    path: str,
    metrics: Optional[Sequence[str]] = None,
    title: str = "Training curves",
):
    """Save a two-panel metrics/loss figure mirroring GDCF_Final.py:99-117.

    ``history`` maps metric name -> per-epoch values (arrays or tensors).
    ``metrics`` selects the left-panel curves; default = every non-loss
    scalar series. Keys containing ``loss`` always go to the right panel.
    Returns the matplotlib Figure.
    """
    plt = require_matplotlib()
    series = {}
    for k, v in history.items():
        if k.startswith("_"):  # internal scalars (e.g. _param_checksum)
            continue
        arr = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if arr.ndim == 1 and arr.size > 0 and np.issubdtype(arr.dtype, np.number):
            series[k] = arr
    loss_keys = sorted(k for k in series if "loss" in k)
    if metrics is None:
        metric_keys = sorted(k for k in series if "loss" not in k)
    else:
        metric_keys = [k for k in metrics if k in series]

    fig = plt.figure(figsize=(12, 6))
    ax = fig.add_subplot(1, 2, 1)
    for k in metric_keys:
        ax.plot(range(1, len(series[k]) + 1), series[k], label=k)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Metric Value")
    ax.set_title(title)
    if metric_keys:
        ax.legend(fontsize=8)

    ax2 = fig.add_subplot(1, 2, 2)
    for k in loss_keys:
        ax2.plot(range(1, len(series[k]) + 1), series[k], label=k)
    ax2.set_xlabel("Epoch")
    ax2.set_ylabel("Loss Value")
    ax2.set_title("Loss vs. Epoch")
    if loss_keys:
        ax2.legend(fontsize=8)

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return fig
