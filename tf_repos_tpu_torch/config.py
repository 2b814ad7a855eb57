"""Unified configuration: the port's own copy of the JAX package's Config.

Every flag keeps its name so the same command lines work against either
package. The port adds one field, ``device`` (default ``cuda``). Flags
whose code path this port does not have yet are accepted by the parser
and rejected with NotImplementedError by the harness
(train/harness.check_supported), never silently ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
from typing import List, Optional


@dataclasses.dataclass
class Config:
    # ---- distribution (reference flag names; host lists are accepted for
    # CLI compatibility only)
    dist_mode: int = 0
    ps_hosts: str = ""
    worker_hosts: str = ""
    job_name: str = ""
    task_index: int = 0
    num_threads: int = 16

    # ---- model shape
    feature_size: int = 0
    field_size: int = 0
    embedding_size: int = 32
    deep_layers: str = "256,128,64"
    dropout: str = "0.5,0.5,0.5"
    batch_norm: bool = False
    batch_norm_decay: float = 0.9

    # ---- optimization
    num_epochs: int = 10
    batch_size: int = 64
    log_steps: int = 1000
    learning_rate: float = 0.0005
    l2_reg: float = 0.0001
    loss_type: str = "log_loss"  # {square_loss, log_loss}
    optimizer: str = "Adam"  # {Adam, Adagrad, GD, Momentum, ftrl}

    # ---- IO / lifecycle
    data_dir: str = ""
    dt_dir: str = ""
    model_dir: str = ""
    servable_model_dir: str = ""
    task_type: str = "train"  # {train, eval, eval_loop, infer, export}
    clear_existing_model: bool = False

    # ---- model-specific flags of the other models
    model_type: str = ""
    cross_layers: int = 3
    attention_layers: str = "256"
    attention_pooling: bool = True
    ctr_task_wgt: float = 0.5

    # ---- model selection
    model: str = "DeepFM"

    # ---- preset: expands to a flag set (PRESETS below); explicit flags win
    preset: str = ""

    # ---- observability
    write_metrics: bool = True
    profile_steps: int = 0
    profile_start_step: int = 10
    check_numerics: bool = False
    eval_loop_secs: int = 30
    eval_loop_timeout: int = 3600

    # ---- execution knobs
    seed: int = 2018
    mesh_data: int = -1
    mesh_model: int = 1
    param_dtype: str = "float32"
    compute_dtype: str = "float32"  # bfloat16 for the dense towers
    shuffle_buffer: int = 256
    prefetch_batches: int = 8
    eval_throttle_secs: int = 1200
    eval_decision_steps: int = 100
    save_checkpoints_steps: int = 0
    keep_checkpoint_max: int = 5
    field_blocks: str = ""
    # K training steps per host iteration; the port runs them as a plain
    # loop of K single steps (log/eval/ckpt cadences round to K)
    steps_per_dispatch: int = 1
    graceful_shutdown: bool = True
    # first N libsvm fields carry constant ids 1..N (Criteo layout): their
    # rows are sliced instead of gathered (models/deepfm.py)
    static_fields: int = 0
    slim_transfer: bool = False
    # lazy touched-rows optimizer updates for the embedding table
    # (train/sparse.py): only the rows present in the batch move
    sparse_table_update: bool = False
    fused_moments: bool = False
    # fuse table and Adam moments into one [V,3K] w|m|v row store: one row
    # gather and one row write-back per step (train/sparse.py)
    fused_table: bool = False
    dma_scatter: bool = False
    # per-row Adam moment catch-up (beta^delta decay on touch)
    sparse_catchup: bool = False
    # uids padding policy of the host dedup mapper: "pow2" (quarter-pow2
    # ladder, monotonic growth), "max", or "pow2:<floor>"
    sparse_pad_mode: str = "pow2"
    # kept under its JAX-package name for CLI compatibility; in the port it
    # selects the hand-written CUDA row-expand / row-accumulate kernels
    # (ops/sparse_rows.py) for the sparse path's inner lookup
    pallas_expand: bool = False
    mh_coo: bool = False
    mh_coo_floor: int = 0
    mh_coo_combine: bool = True
    coo_sorted_bwd: bool = False
    mh_bucket: str = "off"
    map_workers: int = 1
    packed_cache: bool = False
    multi_hot_pad: int = 64

    # ---- port only: the torch device the entry points run on. "cuda"
    # raises when no GPU is present; only an explicit "cpu" runs there.
    device: str = "cuda"

    # -------------------------------------------------------------- helpers
    @property
    def tower_dtype(self):
        """None for f32; otherwise the compute dtype string ("bfloat16")
        passed to the dense towers (mixed precision: params stay f32)."""
        return None if self.compute_dtype in ("float32", "f32", "") else self.compute_dtype

    @property
    def deep_layers_list(self) -> List[int]:
        return [int(x) for x in self.deep_layers.split(",") if x]

    @property
    def dropout_list(self) -> List[float]:
        return [float(x) for x in self.dropout.split(",") if x]

    @property
    def attention_layers_list(self) -> List[int]:
        return [int(x) for x in self.attention_layers.split(",") if x]

    def resolve_dt_dir(self) -> str:
        """Yesterday's date unless set (daily-partition warm start)."""
        if self.dt_dir:
            return self.dt_dir
        return (datetime.date.today() - datetime.timedelta(days=1)).strftime("%Y%m%d")

    def resolved_model_dir(self) -> str:
        return self.model_dir + self.resolve_dt_dir() if self.model_dir else self.model_dir

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    @classmethod
    def with_preset(cls, name: str = "", **overrides) -> "Config":
        """Programmatic preset expansion; overrides win over the preset."""
        name = name or overrides.get("preset", "")
        overrides.pop("preset", None)
        base = dict(expand_preset(name))
        base.update(overrides)
        return cls(preset=name, **base)


# Flag sets per operating regime, identical to the JAX package's, so a
# preset name means the same flags in both.
PRESETS = {
    "criteo_headline": dict(
        batch_size=16384, learning_rate=2e-3, static_fields=13,
        compute_dtype="bfloat16", packed_cache=True, slim_transfer=True,
        steps_per_dispatch=8,
    ),
    "criteo_singlepass": dict(
        batch_size=16384, learning_rate=2e-3, static_fields=13,
        compute_dtype="bfloat16", packed_cache=True, slim_transfer=True,
        steps_per_dispatch=8, sparse_table_update=True, pallas_expand=True,
        sparse_catchup=True,
    ),
    "esmm_large_vocab": dict(
        batch_size=4096, sparse_table_update=True, pallas_expand=True,
        mh_coo=True, mh_bucket="pow2", fused_table=True,
        sparse_catchup=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        packed_cache=True, slim_transfer=True, steps_per_dispatch=64,
        map_workers=2, multi_hot_pad=0,
    ),
    "din_large_vocab": dict(
        batch_size=4096, sparse_table_update=True, pallas_expand=True,
        mh_coo=True, mh_bucket="pow2", fused_table=True,
        sparse_catchup=True,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        packed_cache=True, steps_per_dispatch=8, map_workers=2,
        multi_hot_pad=0,
    ),
    "multihost": dict(
        sparse_table_update=True, steps_per_dispatch=8, map_workers=2,
        packed_cache=True,
    ),
}

_HELP = {
    "pallas_expand": (
        "name kept for CLI compatibility with the JAX package: selects the "
        "hand-written CUDA row-expand / row-accumulate kernels for the "
        "sparse path's inner lookup (requires --sparse_table_update)"
    ),
    "device": "torch device: cuda (default; raises without a GPU) or cpu",
}


def expand_preset(name: str) -> dict:
    if name not in PRESETS:
        raise ValueError(
            f"unknown --preset {name!r}; available: {', '.join(sorted(PRESETS))}"
        )
    return dict(PRESETS[name])


def add_config_args(
    parser: argparse.ArgumentParser, suppress_defaults: bool = False
) -> None:
    """Register every Config field as a --flag. suppress_defaults: unpassed
    flags are absent from the namespace, so --preset expansion can tell
    explicit flags (which override the preset) from defaults."""
    for f in dataclasses.fields(Config):
        default = argparse.SUPPRESS if suppress_defaults else f.default
        help_text = f"{_HELP[f.name]} " if f.name in _HELP else ""
        help_text += f"(default: {f.default})"
        kind = _str2bool if (f.type == "bool" or f.type is bool) else type(f.default)
        parser.add_argument(f"--{f.name}", type=kind, default=default, help=help_text)


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1", "yes", "y", "t")


def parse_config(argv: Optional[List[str]] = None) -> Config:
    parser = argparse.ArgumentParser(description="tf_repos_tpu_torch")
    add_config_args(parser, suppress_defaults=True)
    args, _ = parser.parse_known_args(argv)
    explicit = vars(args)
    values = {}
    preset = explicit.get("preset", "")
    if preset:
        values.update(expand_preset(preset))
    values.update(explicit)
    return Config(**values)


def echo_config(cfg: Config, log=print) -> None:
    """Hyperparameter echo at startup."""
    for f in dataclasses.fields(Config):
        log(f"{f.name} = {getattr(cfg, f.name)}")
