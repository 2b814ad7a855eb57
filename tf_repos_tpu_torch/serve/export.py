"""Versioned servable export (counterpart of the JAX package's
serve/export.py), in the same on-disk layout, so a servable written by
either package loads in the other. A version is a unix-timestamp
directory under servable_dir holding:

  saved_model.json   signature: model name and class, version, the
                     raw-tensor input spec per input format, output
                     keys, and the config that rebuilds f(x)
  variables.npz      every param and model-state leaf as a contiguous
                     f32 array, keyed ``params/<path>`` and
                     ``state/<path>``, the path's dict keys and list
                     indices joined with ``|`` as JAX's tree paths are

The config is written without the port's one extra field, ``device``
(the JAX package's Config takes no such key); the loader takes the
device from its caller. A fused row store's table is exported as its
[V, K] view, copied contiguous: no spare row, no pad lanes, the shape
the JAX package exports."""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Tuple

import numpy as np
import torch

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.models import create_model, input_format
from tf_repos_tpu_torch.models.base import CtrModel
from tf_repos_tpu_torch.utils.convert import params_from_jax
from tf_repos_tpu_torch.utils.platform import resolve_device

_SEP = "|"


def _flatten(tree: Any, prefix: Tuple = ()) -> Dict[str, np.ndarray]:
    """{path: array} in tree order (dict keys sorted, as jax.tree does)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flatten(tree[key], prefix + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flatten(x, prefix + (i,)).items()}
    return {_SEP.join(str(p) for p in prefix): tree.detach().cpu().contiguous().numpy()}


def _unflatten(like: Any, flat: Dict[str, np.ndarray], prefix: Tuple = ()) -> Any:
    """A tree shaped like ``like`` with its leaves taken from ``flat`` by
    path; a leaf's array must have the template's shape."""
    if isinstance(like, dict):
        return {k: _unflatten(v, flat, prefix + (k,)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, flat, prefix + (i,)) for i, v in enumerate(like))
    key = _SEP.join(str(p) for p in prefix)
    if key not in flat:
        raise KeyError(f"servable has no variable {key!r}")
    arr = flat[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"servable variable {key!r} has shape {arr.shape}, the model "
                         f"expects {tuple(like.shape)}")
    return arr


def _input_signature(model: CtrModel) -> Dict[str, Dict]:
    """Raw-tensor input signature per input format, as the JAX package
    writes it (libsvm, csv and Ali-CCP)."""
    cfg = model.cfg
    fmt = input_format(model)
    if fmt == "csv":
        return {
            "cont": {"dtype": "float32", "shape": [None, 13]},
            "cat": {"dtype": "int32", "shape": [None, 26]},
        }
    if fmt == "aliccp":
        p = cfg.multi_hot_pad
        sig: Dict[str, Dict] = {
            "feat_ids": {"dtype": "int32", "shape": [None, cfg.field_size]},
            "a_catids": {"dtype": "int32", "shape": [None]},
            "a_shopids": {"dtype": "int32", "shape": [None]},
            "a_brandids": {"dtype": "int32", "shape": [None]},
            "a_intids": {"dtype": "int32", "shape": [None, p]},
        }
        for f in ("u_cat", "u_shop", "u_brand", "u_int"):
            sig[f"{f}ids"] = {"dtype": "int32", "shape": [None, p]}
            sig[f"{f}vals"] = {"dtype": "float32", "shape": [None, p]}
        return sig
    return {
        "feat_ids": {"dtype": "int32", "shape": [None, cfg.field_size]},
        "feat_vals": {"dtype": "float32", "shape": [None, cfg.field_size]},
    }


def export_servable(servable_dir: str, model: CtrModel, params: Any, mstate: Any) -> str:
    version = str(int(time.time()))
    out_dir = os.path.join(servable_dir, version)
    os.makedirs(out_dir, exist_ok=True)
    config = dataclasses.asdict(model.cfg)
    config.pop("device")
    signature = {
        "model": model.name,
        "model_class": type(model).__name__,
        "version": version,
        "inputs": _input_signature(model),
        "outputs": list(model.prediction_keys),
        "config": config,
    }
    with open(os.path.join(out_dir, "saved_model.json"), "w") as f:
        json.dump(signature, f, indent=2)
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"state/{k}": v for k, v in _flatten(mstate).items()})
    np.savez(os.path.join(out_dir, "variables.npz"), **flat)
    print(f"servable exported to {out_dir}")
    return out_dir


def latest_version_dir(servable_dir: str) -> str:
    versions = [d for d in os.listdir(servable_dir) if d.isdigit()]
    if not versions:
        raise FileNotFoundError(f"no servable versions under {servable_dir}")
    return os.path.join(servable_dir, max(versions, key=int))


def load_servable(version_dir: str, device="cuda") -> Tuple[CtrModel, Any, Any, Dict]:
    """Rebuild (model, params, mstate, signature) from an export dir of
    either package, the weights as f32 tensors on ``device``: the card
    unless the caller asks for the CPU (resolve_device raises when CUDA
    is absent)."""
    device = resolve_device(str(device))
    with open(os.path.join(version_dir, "saved_model.json")) as f:
        signature = json.load(f)
    cfg = Config(**dict(signature["config"], device=str(device)))
    model = create_model(cfg)
    # the tree's structure and shapes without drawing the weights (the
    # counterpart of jax.eval_shape over init)
    with torch.device("meta"):
        params_like, state_like = model.init(None)
    data = np.load(os.path.join(version_dir, "variables.npz"))
    flat_p = {k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")}
    flat_s = {k[len("state/"):]: data[k] for k in data.files if k.startswith("state/")}
    params, mstate = params_from_jax(_unflatten(params_like, flat_p),
                                     _unflatten(state_like, flat_s), device)
    return model, params, mstate, signature
