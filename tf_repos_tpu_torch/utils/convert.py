"""Weights and lazy optimizer state from the JAX package into the port.

The JAX package keeps params and model state as pytrees of nested dicts
and lists; a caller hands them over as numpy arrays (for example
``jax.tree.map(np.asarray, params)``). The port uses the same layout, so
conversion is a copy into tensors; both sides then compute the same
function on the same weights."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tf_repos_tpu_torch.utils.tree import tree_map


def _tensor(x: Any, device) -> torch.Tensor:
    a = np.array(x, copy=True)
    if a.dtype.kind == "f" and a.dtype != np.float32:
        a = a.astype(np.float32)
    return torch.from_numpy(a).to(device)


def shard_of(a: Any, shard: Tuple[int, int]) -> np.ndarray:
    """Rows of model shard m of n of a mesh-padded [V_pad, ...] array
    (pad_vocab: V_pad divides by n): [m * V_pad/n, (m + 1) * V_pad/n)."""
    a = np.asarray(a)
    m, n = shard
    if a.shape[0] % n:
        raise ValueError(f"{a.shape[0]} rows do not split into {n} shards (pad with pad_vocab)")
    vl = a.shape[0] // n
    return a[m * vl: (m + 1) * vl]


def params_from_jax(params_np: Any, mstate_np: Any, device="cpu",
                    shard: Optional[Tuple[int, int]] = None, sharded=()) -> Tuple[Any, Any]:
    """(params, mstate) trees of numpy arrays -> the port's trees of
    float32 tensors on ``device``. With ``shard=(m, n)`` the params are a
    JAX mesh state's (the ``sharded`` tables padded by pad_vocab) and
    those tables become model rank m's shard."""
    conv = lambda x: _tensor(x, device)  # noqa: E731
    if shard is not None:
        params_np = {k: shard_of(v, shard) if k in sharded else v for k, v in params_np.items()}
    return tree_map(conv, params_np), tree_map(conv, mstate_np)


def _store_tensor(x: Any, device) -> torch.Tensor:
    """A numpy array (bf16 from ml_dtypes included) -> a tensor of the
    same dtype and bits."""
    a = np.array(x, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _spare(t: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, t.new_zeros((1,) + tuple(t.shape[1:]))])


def sparse_state_from_jax(aux_np: Dict[str, Any], table_np: Any = None, device="cpu",
                          shard: Optional[Tuple[int, int]] = None) -> Dict[str, Any]:
    """The JAX package's lazy row state of one table (numpy arrays under
    its names: ``wmv``, ``mv``, ``nz``, ``m``, ``v``, ``a``, ``n``, ``z``,
    ``mo``, the step count ``t`` and ``last``) -> the port's aux of the same
    optimizer: every [V, ...] array becomes a row store with its zero
    spare row V, dtypes and bits kept; ``t`` becomes an int. The unfused
    optimizers keep the table in the store ``w``, so ``table_np`` (the
    [V, K] table of the JAX params) is required there; the fused store's
    width K is the table's, or a third of ``wmv``'s width without one.
    With ``shard=(m, n)`` the state is a JAX mesh state's (every array
    padded by pad_vocab) and becomes model rank m's shard: each store
    the shard's rows and a zero spare row (parallel/sparse_step.py)."""
    rows = (lambda a: shard_of(a, shard)) if shard is not None else (lambda a: a)  # noqa: E731
    aux: Dict[str, Any] = {}
    for name, x in aux_np.items():
        if name == "t":
            aux["t"] = int(np.asarray(x))
        else:
            aux[name] = _spare(_store_tensor(rows(x), device))
    if "wmv" in aux_np:
        aux["k"] = (int(np.shape(table_np)[-1]) if table_np is not None
                    else int(np.shape(aux_np["wmv"])[-1]) // 3)
    else:
        if table_np is None:
            raise ValueError("sparse_state_from_jax: the unfused state needs the table")
        aux["w"] = _spare(_store_tensor(rows(table_np), device))
    return aux
