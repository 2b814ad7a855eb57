"""Model registry, with the JAX package's names and aliases: LR, DeepFM,
NFM, AFM, DCN, DeepMVM, DIN, ESMM (alias DeepCvrMTL), the PNN family
(pnn, fnn, ipnn/inner, opnn/outer) and Wide&Deep (wide_n_deep, widedeep,
wdl; wide and deep fix its model_type)."""

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
from tf_repos_tpu_torch.models.wide_deep import WideDeep

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
    "wide_n_deep": WideDeep,
    "widedeep": WideDeep,
    "wdl": WideDeep,
    "wide": lambda cfg: WideDeep(cfg, model_type="wide"),
    "deep": lambda cfg: WideDeep(cfg, model_type="deep"),
}

# the batch layout each model reads (the harness picks the reader)
INPUT_FORMAT: Dict[str, str] = {"ESMM": "aliccp", "DIN": "aliccp", "wide_n_deep": "csv"}


def model_names():
    return sorted(_REGISTRY)


def create_model(cfg: Config) -> CtrModel:
    key = cfg.model.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown model {cfg.model!r}; choose from {model_names()}")
    return _REGISTRY[key](cfg)


def input_format(model: CtrModel) -> str:
    return INPUT_FORMAT.get(model.name, "libsvm")
