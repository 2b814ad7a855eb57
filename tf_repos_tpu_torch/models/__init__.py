"""Model registry. Ported so far: DeepFM, ESMM (alias DeepCvrMTL) and
DIN; every other model name of the JAX package's registry raises
NotImplementedError."""

from __future__ import annotations

from typing import Callable, Dict

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.models.base import CtrModel
from tf_repos_tpu_torch.models.deepfm import DeepFM
from tf_repos_tpu_torch.models.din import DIN
from tf_repos_tpu_torch.models.esmm import ESMM

_REGISTRY: Dict[str, Callable[[Config], CtrModel]] = {
    "deepfm": DeepFM, "esmm": ESMM, "deepcvrmtl": ESMM, "din": DIN,
}

# the JAX package's other model names, not ported yet
_NOT_PORTED = (
    "lr", "nfm", "afm", "dcn", "deepmvm", "pnn",
    "fnn", "ipnn", "inner", "opnn", "outer", "wide_n_deep", "widedeep", "wdl",
    "wide", "deep",
)

INPUT_FORMAT: Dict[str, str] = {"ESMM": "aliccp", "DIN": "aliccp"}


def model_names():
    return sorted(_REGISTRY)


def create_model(cfg: Config) -> CtrModel:
    key = cfg.model.lower()
    if key in _NOT_PORTED:
        raise NotImplementedError(
            f"--model={cfg.model}: not ported to tf_repos_tpu_torch yet "
            f"(ported: {model_names()})"
        )
    if key not in _REGISTRY:
        raise ValueError(f"unknown model {cfg.model!r}; choose from {model_names()}")
    return _REGISTRY[key](cfg)


def input_format(model: CtrModel) -> str:
    return INPUT_FORMAT.get(model.name, "libsvm")
