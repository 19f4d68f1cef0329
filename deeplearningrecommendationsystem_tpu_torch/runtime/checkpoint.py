"""Checkpoint / resume with ``torch.save``.

The JAX package's ``runtime/checkpoint.py`` keeps ``{params, opt_state, rng,
step}`` per step with orbax. The port keeps the same state in its own format:
one directory per step under ``directory`` (named by the step), holding
``state.pt``, a ``torch.save`` of plain dicts of CPU tensors. A step is
written to a temporary directory and then renamed into place, so a reader
never finds a step half written; the newest ``max_to_keep`` steps are kept.

What may be saved: params (name -> tensor), an optimizer state as nested
dicts of tensors (the Trainer's Adam state by param name, or the sparse
trainer's ``{"dense": ..., "sparse": ...}``, whose ``LazyAdamState`` and
``RowwiseAdagradState`` are saved as dicts of their fields), and the data
order's generator (a ``torch.Generator``'s state, or a seed). ``restore``
loads with ``weights_only=True`` onto an explicit ``device`` (CUDA by
default, which raises where there is none), and with a ``template`` checks
that every leaf it names exists with the same shape, raising otherwise.

A JAX orbax checkpoint does not load here; its arrays cross over through
``weights.py`` (``params_from_jax``, ``opt_state_from_jax``).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, Mapping, Optional

import torch

from deeplearningrecommendationsystem_tpu_torch.device import resolve_device

STATE_FILE = "state.pt"


def _plain(tree: Any) -> Any:
    """``tree`` as nested dicts and lists of CPU tensors and numbers: a state
    dataclass as a dict of its fields, a generator by its state."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, torch.Generator):
        return tree.get_state()
    if dataclasses.is_dataclass(tree):
        return _plain({f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)})
    if isinstance(tree, Mapping):
        return {str(k): _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    if isinstance(tree, (int, float, bool, str)) or tree is None:
        return tree
    raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _leaves(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """{dotted path: leaf} of nested dicts and lists."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def check_template(state: Mapping, template: Mapping) -> None:
    """Raise ``ValueError`` unless every leaf of ``template`` is in ``state``
    under the same path, no leaf of ``state`` under the template's top-level
    keys is missing from it, and each tensor leaf has the template's shape."""
    want = _leaves(_plain(template))
    got = _leaves({k: state[k] for k in template if k in state})
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"checkpoint does not match the template: missing {missing}, "
                         f"unexpected {extra}")
    for path, w in want.items():
        g = got[path]
        if isinstance(w, torch.Tensor) and (not isinstance(g, torch.Tensor) or g.shape != w.shape):
            shape = tuple(g.shape) if isinstance(g, torch.Tensor) else type(g).__name__
            raise ValueError(f"checkpoint {path}: {shape} where the template has "
                             f"{tuple(w.shape)}")


class CheckpointManager:
    """Save and restore ``{params, opt_state, rng, step}`` per step."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list:
        """The steps on disk, ascending."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.isfile(
                          os.path.join(self.directory, name, STATE_FILE)))

    def save(self, step: int, params: Any, opt_state: Any = None, rng: Any = None) -> None:
        state = {"params": _plain(params), "step": int(step)}
        if opt_state is not None:
            state["opt_state"] = _plain(opt_state)
        if rng is not None:
            state["rng"] = _plain(rng if isinstance(rng, (torch.Tensor, torch.Generator))
                                  else torch.as_tensor(rng))
        final = os.path.join(self.directory, str(int(step)))
        tmp = os.path.join(self.directory, f".tmp-{int(step)}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        for old in self.steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template: Any = None,
                device: str | torch.device = "cuda") -> dict:
        """The state saved at ``step`` (the latest by default), its tensors on
        ``device``; checked against ``template`` when one is given."""
        dev = resolve_device(device)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, str(int(step)), STATE_FILE)
        state = torch.load(path, map_location=dev, weights_only=True)
        if template is not None:
            check_template(state, template)
        return state

    def close(self) -> None:
        """Nothing is held open between calls; kept for the JAX interface."""
