"""Optimizers for the dense parameters (counterpart of the JAX package's
train/optimizers.py), with the reference's settings (DeepFM.py:204-211):

  Adam      optax.adam: b1 0.9, b2 0.999, eps 1e-8, eps_root 0
              mu = b1*mu + (1-b1)*g;  nu = b2*nu + (1-b2)*g^2;  t += 1
              p -= lr * (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps)
  Adagrad   TF AdagradOptimizer, accumulator from 1e-8, no epsilon:
              a += g^2;  p -= lr * g * rsqrt(a)
  Momentum  optax.sgd(lr, momentum=0.95): trace = g + 0.95*trace;
              p -= lr * trace
  ftrl      FTRL-Proximal with TF FtrlOptimizer's defaults
              (lr_power -0.5, accumulator from 0.1, l1 = l2 = 0)
  GD, SGD   p -= lr * g (the reference advertises GD but has no branch
              for it; the JAX package makes it plain SGD)
  wdl       the TF1 canned-estimator composite of the wide_n_deep family:
              FTRL on the ``wide*`` parameters, Adagrad from 0.1 on the
              rest, at the canned rates of canned_wdl_rates (any
              --learning_rate is ignored, with a warning)

Each optimizer has ``init(tree) -> state`` and an in-place
``update_(params, grads, state)`` over the leaves in tree_leaves order of
the tree ``state`` was initialised from. The updates run on the foreach
kernels (a handful of launches for the whole tree instead of a few per
tensor). FTRL, as optax applies it, adds ``w_new - p`` to p rather than
storing w_new, so its rounding is the JAX package's. Adam computes its
bias corrections on the device (BiasCorrections), so a step replayed from
a CUDA graph uses its own step count."""

from __future__ import annotations

import math
import warnings
from typing import Any, Dict, List, Tuple

import torch

from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_map


def _capturing(device: torch.device) -> bool:
    """True while the current stream of a card records a CUDA graph."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


class BiasCorrections:
    """Adam's bias corrections [1 - b1^t, 1 - b2^t] computed on the
    device from a device copy of the step count t (one a state dict), so
    that a step replayed from a CUDA graph (train/step_graph.py) uses its
    own t: an eager step fills the copy with t, a step being captured
    adds one to it, and both run the same operations. ``dtype`` is the
    precision of the powers: float32 is powf, as the JAX package's lazy
    rows take it; float64 is the Python scalar optax's dense update
    divided by. The result is rounded to f32; on the CPU it is, bit for
    bit, the scalar each update divided by before. On a card the f32
    powers are CUDA's powf, an ulp from the CPU's at some t (72 of
    t <= 4,096 at b = 0.999, none at 0.9); the f64 ones agree."""

    def __init__(self, b1: float, b2: float, dtype: torch.dtype):
        self._b, self._dtype = (b1, b2), dtype
        self._betas: Dict[torch.device, torch.Tensor] = {}
        self._counts: Dict[int, torch.Tensor] = {}

    def advance(self, state: Dict[str, Any], key: str, device) -> Tuple[int, torch.Tensor]:
        """Advance the count state[key] by one step: (the new count t, the
        [2] f32 corrections on ``device``)."""
        t = state[key] = state[key] + 1
        count, betas = self._counts.get(id(state)), self._betas.get(device)
        if _capturing(device):
            if count is None or betas is None or count.device != device:
                raise RuntimeError("the step count has no copy on the device: step eagerly first")
            count.add_(1)
        else:
            if betas is None:
                betas = self._betas[device] = torch.tensor(self._b, dtype=self._dtype,
                                                           device=device)
            if count is None or count.device != device:
                count = self._counts[id(state)] = torch.empty((), dtype=torch.int64,
                                                              device=device)
            count.fill_(t)
        return t, (1.0 - torch.pow(betas, count)).float()


class Adam:
    def __init__(self, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.steps = BiasCorrections(b1, b2, torch.float64)

    def init(self, params: Any) -> Dict[str, Any]:
        return {
            "count": 0,
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                state: Dict[str, Any]) -> None:
        """In-place step. params/grads: leaves in tree_leaves order of the
        tree ``state`` was initialised from."""
        if not params:
            return
        b1, b2 = self.b1, self.b2
        mu, nu = tree_leaves(state["mu"]), tree_leaves(state["nu"])
        _, c = self.steps.advance(state, "count", mu[0].device)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(nu, b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(nu, c[1])
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu, c[0])
        torch._foreach_div_(step, denom)
        torch._foreach_add_(params, step, alpha=-self.lr)


class SGD:
    """optax.sgd: plain, or with a momentum trace (nesterov off)."""

    def __init__(self, learning_rate: float, momentum: float = 0.0):
        self.lr, self.momentum = learning_rate, momentum

    def init(self, params: Any) -> Dict[str, Any]:
        if not self.momentum:
            return {}
        return {"trace": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, params, grads, state) -> None:
        if not params:
            return
        if not self.momentum:
            torch._foreach_add_(params, grads, alpha=-self.lr)
            return
        trace = tree_leaves(state["trace"])
        torch._foreach_mul_(trace, self.momentum)
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, trace, alpha=-self.lr)


class AdagradTF:
    """TF AdagradOptimizer: accum += g^2; p -= lr * g * rsqrt(accum). No
    epsilon, unlike optax.adagrad."""

    def __init__(self, learning_rate: float, initial_accumulator_value: float = 1e-8):
        self.lr, self.init_acc = learning_rate, initial_accumulator_value

    def init(self, params: Any) -> Dict[str, Any]:
        return {"accum": tree_map(lambda p: torch.full_like(p, self.init_acc), params)}

    @torch.no_grad()
    def update_(self, params, grads, state) -> None:
        if not params:
            return
        accum = tree_leaves(state["accum"])
        torch._foreach_addcmul_(accum, grads, grads)
        step = torch._foreach_rsqrt(accum)
        torch._foreach_mul_(step, grads)
        torch._foreach_add_(params, step, alpha=-self.lr)


class Ftrl:
    """FTRL-Proximal (McMahan et al. 2013) with TF FtrlOptimizer's defaults
    (lr_power P = -0.5, accumulator from 0.1, l1 = l2 = 0, the only values
    the reference and the JAX package use):

      n1 = n + g^2
      z1 = z + g - ((n1^-P - n^-P) / lr) * w
      w_new = 0 where |z1| <= l1, else -(z1 - sign(z1)*l1) / (n1^-P / lr + 2*l2)

    and p <- p + (w_new - p), as optax applies it."""

    P, INIT, L1, L2 = -0.5, 0.1, 0.0, 0.0

    def __init__(self, learning_rate: float):
        self.lr = learning_rate

    def init(self, params: Any) -> Dict[str, Any]:
        return {"n": tree_map(lambda x: torch.full_like(x, self.INIT), params),
                "z": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, params, grads, state) -> None:
        if not params:
            return
        lr, p, l1, l2 = self.lr, self.P, self.L1, self.L2
        ns, zs = tree_leaves(state["n"]), tree_leaves(state["z"])
        s0 = torch._foreach_pow(ns, -p)
        torch._foreach_addcmul_(ns, grads, grads)  # n1
        s1 = torch._foreach_pow(ns, -p)
        shift = torch._foreach_sub(s1, s0)
        torch._foreach_div_(shift, lr)
        torch._foreach_mul_(shift, params)
        torch._foreach_add_(zs, grads)  # z1 = (z + g) - shift
        torch._foreach_sub_(zs, shift)
        denom = torch._foreach_div(s1, lr)
        torch._foreach_add_(denom, 2.0 * l2)
        num = torch._foreach_sub(zs, torch._foreach_mul(torch._foreach_sign(zs), l1))
        q = torch._foreach_div(num, denom)
        torch._foreach_neg_(q)
        upd = [torch.where(torch.abs(z) <= l1, 0.0, x) - w for z, x, w in zip(zs, q, params)]
        torch._foreach_add_(params, upd)


class WdlComposite:
    """The canned wide_n_deep composite (optax.multi_transform in the JAX
    package): leaves under a top-level key starting with ``wide`` train
    with ftrl(wide_lr), every other leaf (``bias`` included) with
    Adagrad(deep_lr) from an accumulator of 0.1. The split is made at
    init from the tree's top-level keys and kept in the state."""

    def __init__(self, model_type: str = "wide_n_deep"):
        wide_lr, deep_lr = canned_wdl_rates(model_type)
        self.parts = {"wide": Ftrl(wide_lr), "deep": AdagradTF(deep_lr, 0.1)}

    def init(self, params: Dict[str, Any]) -> Dict[str, Any]:
        labels = ["wide" if str(k).startswith("wide") else "deep" for k in sorted(params)
                  for _ in tree_leaves(params[k])]
        state: Dict[str, Any] = {"labels": labels}
        for part, tx in self.parts.items():
            state[part] = tx.init({k: v for k, v in params.items()
                                   if str(k).startswith("wide") == (part == "wide")})
        return state

    def update_(self, params, grads, state) -> None:
        for part, tx in self.parts.items():
            pick = [i for i, label in enumerate(state["labels"]) if label == part]
            tx.update_([params[i] for i in pick], [grads[i] for i in pick], state[part])


def make_optimizer(name: str, learning_rate: float, model_type: str = "wide_n_deep"):
    key = name.lower()
    if key == "adam":
        return Adam(learning_rate)
    if key == "adagrad":
        return AdagradTF(learning_rate, initial_accumulator_value=1e-8)
    if key == "momentum":
        return SGD(learning_rate, momentum=0.95)
    if key == "ftrl":
        return Ftrl(learning_rate)
    if key in ("gd", "sgd"):
        return SGD(learning_rate)
    if key == "wdl":
        # the canned composite derives its rates from model_type: a CLI
        # --learning_rate is ignored, as in the reference (wide_n_deep.py
        # has its lr flag commented out)
        if learning_rate != _DEFAULT_CLI_LR:
            warnings.warn(
                f"optimizer=wdl ignores --learning_rate ({learning_rate}): "
                "the canned composite uses the TF1 canned-estimator rates "
                f"{canned_wdl_rates(model_type)} (wide, deep) derived from "
                f"model_type={model_type!r}. Use --optimizer=ftrl or "
                "adagrad for a custom rate.",
                stacklevel=2,
            )
        return WdlComposite(model_type)
    raise ValueError(f"unknown optimizer {name!r}")


# Config.learning_rate's default (config.py; not imported here, as in the
# JAX package)
_DEFAULT_CLI_LR = 0.0005

# TF1 canned-estimator learning rates (tensorflow_estimator canned/linear.py,
# canned/dnn.py, canned/dnn_linear_combined.py)
_CANNED_LINEAR_LR = 0.2             # LinearClassifier: min(0.2, 1/sqrt(n_cols))
_CANNED_DNN_LR = 0.05               # DNNClassifier: Adagrad(0.05)
_CANNED_COMBINED_LINEAR_LR = 0.005  # DNNLinearCombined linear leg
_CANNED_COMBINED_DNN_LR = 0.001     # DNNLinearCombined dnn leg
_WDL_N_COLUMNS = 39                 # 13 numeric + 26 categorical columns


def canned_wdl_rates(model_type: str) -> tuple:
    """(wide_lr, deep_lr) the reference's runs used: wide_n_deep.py passes
    no optimizer arguments to its canned estimators, so TF1's defaults
    applied: wide and deep -> (min(0.2, 1/sqrt(39)), 0.05); wide_n_deep
    -> (min(0.005, 1/sqrt(39)), 0.001)."""
    root = 1.0 / math.sqrt(_WDL_N_COLUMNS)
    if model_type in ("wide", "deep"):
        return (min(_CANNED_LINEAR_LR, root), _CANNED_DNN_LR)
    return (min(_CANNED_COMBINED_LINEAR_LR, root), _CANNED_COMBINED_DNN_LR)
