"""Carry a model's weights across from the JAX package.

The two packages draw different numbers from the same seed, so a test that
holds the port against the JAX package gives both the same weights: the JAX
params pytree, as NumPy arrays, copied into the port's module. The ported
models keep the JAX pytree's names, a nested dict becoming a submodule, so a
module's state-dict names are the pytree's leaves under dotted names
({"wide": {"w": ...}} -> "wide.w"; a list's items under their index, DIN's
{"att": [{"w": ...}, ...]} -> "att.0.w"). A model whose names differ would add
its own mapping here.

``opt_state_from_jax`` does the same for the optimizer: it turns an optax Adam
state (``ScaleByAdamState``: ``count``, ``mu``, ``nu``, alone or inside the
``torch_adam`` chain) into the port's Adam state by param name, the form
``Trainer.fit(opt_state=...)`` resumes from. It reads the state by its
attributes, so this module imports neither JAX nor optax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

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
    LogisticRegression,
    AutoRec,
    MatrixFactorization,
    NeuralCF,
    WideDeep,
)


def _flat(params: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """The leaves of nested dicts and lists under dotted names."""
    out: Dict[str, np.ndarray] = {}
    for key, value in params.items():
        if isinstance(value, (list, tuple)):
            value = {str(i): v for i, v in enumerate(value)}
        if isinstance(value, Mapping):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


# MF: user [U, D], item [I, D]. LR: user_bias, item_bias, wide.{w, b}. AFM:
# tables.{user, item, gender, occupation, genre}, att_{w, b, h}, att_out.{w, b},
# wide.{user_bias, item_bias, wide.{w, b}}. DIN: item, att.{0,1,2}.{w, b},
# fc.{0,1,2}.{w, b}. DeepFM, WideDeep, NFM: tables.*, deep_in.{w, b},
# deep.{i}.{w, b}, fm_linear.* (DeepFM) or wide.* (the linear part), out.{w, b}.
# PNN: tables.*, lz, lp, dnn.{i}, out. DCN: tables.*, cross.{i}.{w, b}, deep.{i},
# out. DeepCrossing: tables.*, blocks.{i}.{up, down}.{w, b}, out. FFM: the JAX
# table keys hold a dot ("user_id.user"), so the leaf "tables.user_id.user" is
# the parameter "user" of the submodule "user_id" of "tables": the dotted name
# maps as it stands; and lr.{user_bias, item_bias, wide.{w, b}}. DIEN: item,
# att.{i}.{w, b}, gru.{w_ih, w_hh, b_ih, b_hh}, fc.{i}.{w, b} and, with AUGRU,
# gru_ev.*. NeuralCF: gmf_user, gmf_item, mlp_user, mlp_item, mlp.{i}.{w, b},
# proj.{w, b}, out.{w, b}. AutoRec: encoder.{w, b}, decoder.{w, b}.
_PORTED = (MatrixFactorization, LogisticRegression, AFM, DIN, DeepFM, WideDeep, NFM, PNN, DCN,
           DeepCrossing, FFM, DIEN, NeuralCF, AutoRec)


def _to_state(model: nn.Module, tree: Mapping) -> Dict[str, np.ndarray]:
    if type(model) not in _PORTED:
        raise TypeError(f"no JAX weight mapping for {type(model).__name__}")
    return _flat(tree)


def params_from_jax(model: nn.Module, params: Mapping) -> nn.Module:
    """Copy the JAX params pytree ``params`` into ``model`` in place, on the
    model's device and dtype; returns the model."""
    current = model.state_dict()
    state = {}
    for name, array in _to_state(model, params).items():
        if name not in current:
            raise ValueError(f"{name}: no parameter of that name in {type(model).__name__}")
        array = np.asarray(array)
        if tuple(array.shape) != tuple(current[name].shape):
            raise ValueError(
                f"{name}: JAX shape {array.shape} != port shape {tuple(current[name].shape)}"
            )
        state[name] = torch.from_numpy(np.array(array, copy=True))
    model.load_state_dict(state, strict=True)
    return model


def _adam_state(opt_state: Any):
    """The first node of ``opt_state`` (an optax state: nested tuples) that
    carries Adam's ``count``, ``mu`` and ``nu``."""
    if all(hasattr(opt_state, a) for a in ("count", "mu", "nu")):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for sub in opt_state:
            found = _adam_state(sub)
            if found is not None:
                return found
    return None


def opt_state_from_jax(model: nn.Module, opt_state: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """The port's Adam state for ``model`` from the JAX trainer's optax state:
    {param name: {"step", "exp_avg", "exp_avg_sq"}}, the moments mapped as
    ``params_from_jax`` maps the params."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise TypeError("no Adam state (count, mu, nu) in the given optax state")
    mu, nu = _to_state(model, adam.mu), _to_state(model, adam.nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    return {
        name: {
            "step": step.clone(),
            "exp_avg": torch.from_numpy(np.array(mu[name], dtype=np.float32)),
            "exp_avg_sq": torch.from_numpy(np.array(nu[name], dtype=np.float32)),
        }
        for name in mu
    }
