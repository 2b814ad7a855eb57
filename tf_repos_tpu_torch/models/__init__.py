"""Model registry, with the JAX package's names and aliases. Ported so
far: LR, DeepFM, NFM, AFM, DCN, DeepMVM, DIN, ESMM (alias DeepCvrMTL) and
the PNN family (pnn, fnn, ipnn/inner, opnn/outer); the Wide&Deep names
raise NotImplementedError."""

from __future__ import annotations

from typing import Callable, Dict

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.models.afm import AFM
from tf_repos_tpu_torch.models.base import CtrModel
from tf_repos_tpu_torch.models.dcn import DCN
from tf_repos_tpu_torch.models.deepfm import DeepFM
from tf_repos_tpu_torch.models.deepmvm import DeepMVM
from tf_repos_tpu_torch.models.din import DIN
from tf_repos_tpu_torch.models.esmm import ESMM
from tf_repos_tpu_torch.models.lr import LR
from tf_repos_tpu_torch.models.nfm import NFM
from tf_repos_tpu_torch.models.pnn import PNN

_REGISTRY: Dict[str, Callable[[Config], CtrModel]] = {
    "lr": LR,
    "deepfm": DeepFM,
    "nfm": NFM,
    "afm": AFM,
    "dcn": DCN,
    "deepmvm": DeepMVM,
    "din": DIN,
    "esmm": ESMM,
    "deepcvrmtl": ESMM,
    "pnn": PNN,
    "fnn": lambda cfg: PNN(cfg, model_type="FNN"),
    "ipnn": lambda cfg: PNN(cfg, model_type="Inner"),
    "inner": lambda cfg: PNN(cfg, model_type="Inner"),
    "opnn": lambda cfg: PNN(cfg, model_type="Outer"),
    "outer": lambda cfg: PNN(cfg, model_type="Outer"),
}

# the JAX package's other model names, not ported yet
_NOT_PORTED = ("wide_n_deep", "widedeep", "wdl", "wide", "deep")

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
