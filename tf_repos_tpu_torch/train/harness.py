"""Trainer harness (counterpart of the JAX package's train/harness.py) on
one device: the libsvm models (LR, DeepFM, the PNN family, NFM, AFM,
DCN, DeepMVM) and ESMM and DIN on Ali-CCP sample lines.

  train     -> train loop with periodic eval (eval_throttle_secs),
               checkpoints (torch.save under model_dir), a final eval on
               the va* split
  eval      -> one eval pass over the va* files from the newest checkpoint
  eval_loop -> poll model_dir for new checkpoints and evaluate each
               (eval_loop_secs, eval_loop_timeout; eval_metrics.jsonl
               under --write_metrics)
  infer     -> pred.txt from the te* files with the predict step and the
               serving lookup (K1 over the whole table); one process
  export    -> a versioned servable (serve/export.py) under
               servable_model_dir or <model_dir>/servable

The step is the lazy sparse step (train/sparse.py) under
--sparse_table_update, with the hand-written expand/accumulate kernels
as its inner lookup under --pallas_expand and the row-scatter write-back
under --dma_scatter; the dense step otherwise, whose table gradient goes
through the field-block scatter kernel under --field_blocks. LR's 1-D
table takes plain lazy Adam or the dense step: --fused_table and
--pallas_expand raise for it.
Under --mh_coo the training batches' multi-hot fields are packed into a
COO triplet on the host (data/sparse_batch.MhCooPacker, before the dedup
mapper), which the COO pool kernels consume (ESMM), or the sorted-stream
kernels with the packer's compact segment stream (DIN attention; with
--coo_sorted_bwd also its idx-sorted stream); eval and infer batches
stay padded. --mh_bucket slices the padded multi-hot fields of every
split to the batch's live width first. The host input (data/) parses in
C++ (data/native.py), caches the parsed arrays beside each file under
--packed_cache, and under --map_workers N runs the training split's map
chain (bucketer, packer, mapper) on N threads in stream order; a
Prefetcher thread keeps --prefetch_batches batches ready.
--steps_per_dispatch K runs as a plain loop of K steps. Flags whose code
path the port does not have yet (check_supported) raise
NotImplementedError by name."""

from __future__ import annotations

import json
import os
import signal
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from tf_repos_tpu_torch.config import Config, echo_config
from tf_repos_tpu_torch.data.libsvm import LibsvmDataset, glob_input_files
from tf_repos_tpu_torch.data.pipeline import Prefetcher, parallel_mapped_batches
from tf_repos_tpu_torch.data.ragged import MH_PAIRS, AliccpDataset
from tf_repos_tpu_torch.data.sparse_batch import (
    MHC_CDEST,
    MHC_CIDX,
    MHC_DEST,
    MHC_IDX,
    MHC_PERM,
    MHC_SROWS,
    MHC_W,
    UIDS_PREFIX,
    MhCooPacker,
    MhPadBucketer,
    SparseBatchMapper,
    mapped_batches,
)
from tf_repos_tpu_torch.models import create_model, input_format
from tf_repos_tpu_torch.train import loop as L
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager, clear_existing_model
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.platform import resolve_device
from tf_repos_tpu_torch.utils.tree import tree_map


def check_supported(cfg: Config) -> None:
    """Reject, by name, every flag value whose path is not ported yet."""
    unsupported = {
        "--mesh_data>1": cfg.mesh_data > 1,
        "--mesh_model>1": cfg.mesh_model > 1,
        "--dist_mode": cfg.dist_mode != 0,
        "--slim_transfer": cfg.slim_transfer,
        "--fused_moments": cfg.fused_moments,
        f"--param_dtype={cfg.param_dtype}": cfg.param_dtype not in ("float32", "f32", ""),
        "--profile_steps": cfg.profile_steps > 0,
        "--check_numerics": cfg.check_numerics,
    }
    bad = [name for name, hit in unsupported.items() if hit]
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not implemented in tf_repos_tpu_torch yet"
        )
    if cfg.compute_dtype not in ("float32", "f32", "", "bfloat16", "bf16"):
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}")


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device``. A read-only array (a view of
    the packed cache's memmap) is copied first: torch.from_numpy would
    alias it, and on the CPU the tensor would be that read-only memory."""
    def tensor(v):
        a = np.ascontiguousarray(v)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)

    return {k: tensor(v) for k, v in batch.items()}


class GracefulStop:
    """SIGTERM -> finish the current step, checkpoint, stop."""

    def __init__(self, install: bool):
        self.requested = False
        self._prev = None
        self._installed = False
        if install:
            try:
                self._prev = signal.signal(signal.SIGTERM, self._on_signal)
                self._installed = True
            except ValueError:
                pass  # not the main thread

    def _on_signal(self, signum, frame):
        self.requested = True
        print("INFO: SIGTERM received; will checkpoint and stop at a step boundary")

    def restore(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)


class MetricsWriter:
    """Append-only JSONL scalar events in model_dir/filename: {"step",
    "wall", "kind", <scalars>}."""

    def __init__(self, model_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(model_dir, exist_ok=True)
        self._f = open(os.path.join(model_dir, filename), "a", buffering=1)

    def write(self, step: int, scalars: Dict[str, float], kind: str = "train") -> None:
        rec = {"step": int(step), "wall": time.time(), "kind": kind}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


class Harness:
    def __init__(self, cfg: Config):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.model = create_model(cfg)
        self.tx = make_optimizer(cfg.optimizer, cfg.learning_rate)
        self.model_dir = cfg.resolved_model_dir() or "./model_ckpt"
        if self.model.flat_table:
            for flag, on in (("--fused_table", cfg.fused_table),
                             ("--pallas_expand", cfg.pallas_expand)):
                if on:
                    raise ValueError(
                        f"{flag}: {self.model.name}'s table is 1-D [V], which has no fused "
                        "w|m|v row store and no [S, K] rows for the row kernels (the JAX "
                        "package cannot run it there either); use --sparse_table_update "
                        "alone or the dense step"
                    )
        self._sparse_slots = None
        if cfg.sparse_table_update:
            self._sparse_slots = self.model.sparse_slots()
        if cfg.fused_table and self._sparse_slots is None:
            raise ValueError(
                "--fused_table requires --sparse_table_update (the fused "
                "[V,3K] w|m|v storage lives in the lazy sparse row-update path)"
            )
        if cfg.mh_coo:
            if self._sparse_slots is None:
                raise ValueError(
                    "--mh_coo requires --sparse_table_update (the COO idx are "
                    "remapped positions into the batch's unique rows)"
                )
            if not self.model.mh_coo_groups():
                raise ValueError(
                    f"--mh_coo: {self.model.name} declares no multi-hot groups"
                )
        self._mh_bucket = cfg.mh_bucket not in ("", "off")
        if self._mh_bucket and input_format(self.model) != "aliccp":
            raise ValueError(
                "--mh_bucket applies to the Ali-CCP padded multi-hot layout "
                f"(model {self.model.name} reads {input_format(self.model)})"
            )
        self._sopt = None
        if self._sparse_slots is not None:
            self._sopt = SP.make_sparse_row_optimizer(
                cfg.optimizer, cfg.learning_rate, fused_table=cfg.fused_table,
                catchup=cfg.sparse_catchup, dma_scatter=cfg.dma_scatter,
            )
        self._train_step = None

    # ---------------------------------------------------------- state init
    def init_train_state(self) -> Dict[str, Any]:
        gen = torch.Generator().manual_seed(self.cfg.seed)
        params, mstate = self.model.init(gen)
        params = tree_map(lambda t: t.to(self.device), params)
        mstate = tree_map(lambda t: t.to(self.device), mstate)
        if self._sopt is not None:
            opt_state = SP.init_opt_state(self.model, self.tx, self._sopt, params)
        else:
            opt_state = self.tx.init(params)
        return {"params": params, "opt_state": opt_state, "mstate": mstate, "step": 0}

    def restore_or_init(self, ckpt: CheckpointManager) -> Dict[str, Any]:
        restored = ckpt.restore(self.device)
        return restored if restored is not None else self.init_train_state()

    # --------------------------------------------------------- step builder
    def inner_lookup(self):
        """The hand-written expand/accumulate lookup under --pallas_expand
        (the sparse path's inner, remapped-id lookup); None otherwise."""
        if not (self.cfg.pallas_expand and self._sparse_slots is not None):
            return None
        from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup

        return make_expand_lookup()

    def field_block_lookup(self):
        """The field-block lookup under --field_blocks (``off:size,...`` or
        ``auto:<feature_map>``): the plain gather forward and the K8
        field_block_scatter backward (ops/field_block.py). The dense step
        only: the lazy sparse step never reads the flag. None otherwise."""
        cfg = self.cfg
        if not cfg.field_blocks or self._sparse_slots is not None:
            return None
        if cfg.field_blocks.startswith("auto:"):
            from tf_repos_tpu_torch.features.criteo import field_blocks_from_feature_map

            offsets, sizes = field_blocks_from_feature_map(cfg.field_blocks[5:])
        else:
            pairs = [p.split(":") for p in cfg.field_blocks.split(",")]
            offsets = tuple(int(a) for a, _ in pairs)
            sizes = tuple(int(b) for _, b in pairs)
        from tf_repos_tpu_torch.ops.field_block import make_field_block_lookup

        return make_field_block_lookup(cfg.feature_size, offsets, sizes)

    def _get_train_step(self):
        """Unified signature: (state, device_batch, generator) -> (state, loss)."""
        if self._train_step is not None:
            return self._train_step
        if self._sopt is not None:
            inner = SP.build_sparse_train_step(
                self.model, self.tx, self._sopt, lookup=self.inner_lookup()
            )
        else:
            inner = L.build_train_step(self.model, self.tx, lookup=self.field_block_lookup())

        def step(state, batch, generator):
            p, o, m, loss = inner(
                state["params"], state["opt_state"], state["mstate"], batch, generator
            )
            return {"params": p, "opt_state": o, "mstate": m}, loss

        self._train_step = step
        return step

    # ------------------------------------------------------------- datasets
    def _dataset(self, split: str, *, shuffle: bool, epochs: int) -> Iterable:
        """split in {tr, va, te}: the reader of the model's input format,
        then the host map chain (width bucketer on every split; on the
        training split of the sparse step the COO packer and the dedup
        mapper), on --map_workers threads for the training split, behind
        a Prefetcher thread."""
        cfg = self.cfg
        fmt = input_format(self.model)
        if fmt == "aliccp":
            files = [f for f in glob_input_files(cfg.data_dir, f"{split}*", shuffle=shuffle, seed=cfg.seed)
                     if not f.endswith((".libsvm", ".csv"))]
        else:
            files = glob_input_files(cfg.data_dir, f"{split}*{fmt}", shuffle=shuffle, seed=cfg.seed)
        if not files:
            raise FileNotFoundError(f"no {split}* {fmt} input files in {cfg.data_dir}")
        ds: Iterable = self._build_reader(files, fmt, shuffle=shuffle, epochs=epochs)
        factories = []
        if self._mh_bucket:
            # live-width slicing first: smaller id arrays for everything after
            factories.append(lambda: MhPadBucketer(MH_PAIRS, cfg.mh_bucket))
        if split == "tr" and self._sparse_slots is not None:
            if cfg.mh_coo:
                combine = cfg.mh_coo_combine and self.model.coo_combine_ok()
                if cfg.mh_coo_combine and not combine:
                    print(
                        f"WARNING: --mh_coo_combine disabled: {self.model.name} consumes "
                        "the COO w stream nonlinearly (per-slot attention); combining "
                        "duplicate ids would change its math"
                    )
                # the packer first: the mapper then dedups the live COO
                # ids instead of every padded slot. The sorted-stream
                # kernels need the compact segment stream, and
                # --coo_sorted_bwd the idx-sorted stream; both only reach
                # a kernel under --pallas_expand
                groups = self.model.mh_coo_groups()
                floor = max(cfg.mh_coo_floor, 1) if cfg.mh_coo_floor else 1024
                cdest = cfg.pallas_expand and self.model.wants_sorted_seg()
                saux = cfg.coo_sorted_bwd and cfg.pallas_expand and self.model.wants_sorted_aux()
                factories.append(lambda: MhCooPacker(groups, floor=floor, combine=combine,
                                                     cdest_aux=cdest, sorted_aux=saux))
            slots, pad_mode = self._sparse_slots, cfg.sparse_pad_mode
            factories.append(lambda: SparseBatchMapper(slots, pad_mode=pad_mode))
        if cfg.map_workers > 1 and split == "tr" and factories:
            # one chain a worker; pad widths re-padded at the ordered
            # output (data/pipeline.parallel_mapped_batches says why the
            # batches compute the same function)
            def make_chain():
                stages = [f() for f in factories]

                def chain(b):
                    for stage in stages:
                        b = stage(b)
                    return b

                return chain

            ds = parallel_mapped_batches(ds, make_chain, cfg.map_workers, self._map_pad_rules())
        else:
            for f in factories:
                ds = mapped_batches(ds, f())
        return Prefetcher(ds, size=cfg.prefetch_batches)

    def _build_reader(self, files: List[str], fmt: str, *, shuffle: bool, epochs: int) -> Iterable:
        cfg = self.cfg
        common = dict(batch_size=cfg.batch_size, num_epochs=epochs, perform_shuffle=shuffle,
                      shuffle_buffer=cfg.shuffle_buffer, seed=cfg.seed,
                      packed_cache=cfg.packed_cache)
        if fmt == "aliccp":
            return AliccpDataset(files, multi_hot_pad=cfg.multi_hot_pad, **common)
        # --num_threads sizes the native parser's thread pool
        workers = max(1, min(cfg.num_threads, (os.cpu_count() or 4) - 1))
        return LibsvmDataset(files, field_size=cfg.field_size, parse_workers=workers, **common)

    def _map_pad_rules(self) -> Dict[str, Any]:
        """Last-axis re-pad sentinels of the keys whose width the map chain
        buckets (--map_workers): vocab for uids (out of range, dropped by
        the device scatter), 0 for the COO streams and the bucketed
        multi-hot ids/vals (the dead-slot convention)."""
        rules: Dict[str, Any] = {}
        if self._sparse_slots is not None:
            for t, s in self._sparse_slots.items():
                rules[UIDS_PREFIX + t] = s.vocab
        if self.cfg.mh_coo:
            rules.update({MHC_IDX: 0, MHC_DEST: 0, MHC_W: 0.0, MHC_CDEST: 0,
                          # the idx-sorted stream (the device masks sorted
                          # positions >= the live count)
                          MHC_PERM: 0, MHC_CIDX: 0, MHC_SROWS: 0})
        if self._mh_bucket:
            for ids_f, vals_f in MH_PAIRS:
                rules[ids_f] = 0
                if vals_f:
                    rules[vals_f] = 0.0
        return rules

    # ----------------------------------------------------------------- train
    def train(self) -> Dict[str, float]:
        cfg = self.cfg
        ckpt = CheckpointManager(self.model_dir, keep=cfg.keep_checkpoint_max)
        ts = self.restore_or_init(ckpt)
        step = int(ts.pop("step", 0))
        state = {k: ts[k] for k in ("params", "opt_state", "mstate")}
        train_step = self._get_train_step()
        K = max(cfg.steps_per_dispatch, 1)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        writer = MetricsWriter(self.model_dir) if cfg.write_metrics else None
        stop = GracefulStop(cfg.graceful_shutdown)
        losses: List[torch.Tensor] = []
        t0 = time.time()
        last_log, last_eval, last_log_step = t0, t0, step
        metrics: Dict[str, float] = {}
        group: List[Dict[str, np.ndarray]] = []

        def run_group(state, batches):
            for b in batches:
                state, loss = train_step(state, to_device(b, self.device), gen)
                losses.append(loss)
            return state

        for batch in self._dataset("tr", shuffle=True, epochs=cfg.num_epochs):
            group.append(batch)
            if len(group) < K:
                continue
            state = run_group(state, group)
            step += len(group)
            group = []
            # cadence boundaries: "crossed within this group of K steps"
            if step % cfg.log_steps < K:
                now = time.time()
                mean_loss = float(torch.stack(losses[-cfg.log_steps:]).mean())
                rate = (step - last_log_step) / max(now - last_log, 1e-9)
                last_log_step, last_log = step, now
                print(
                    f"INFO: step = {step}, loss = {mean_loss:.5f} "
                    f"({rate:.3f} steps/sec, {rate * cfg.batch_size:.0f} examples/sec)"
                )
                if writer:
                    writer.write(step, {"loss": mean_loss, "examples_per_sec": rate * cfg.batch_size})
                losses = []
            if cfg.save_checkpoints_steps and step % cfg.save_checkpoints_steps < K:
                ckpt.save(step, dict(state, step=step))
            if cfg.eval_throttle_secs and step % cfg.eval_decision_steps < K:
                # (a negative throttle evals at every decision boundary)
                if time.time() - last_eval > cfg.eval_throttle_secs:
                    metrics = self._maybe_eval(state["params"], state["mstate"])
                    if writer and metrics:
                        writer.write(step, metrics, kind="eval")
                    last_eval = time.time()
            if stop.requested:
                print(f"INFO: graceful shutdown: checkpointing at step {step}")
                break
        if group and not stop.requested:  # tail of an unfinished K-group
            state = run_group(state, group)
            step += len(group)
        stop.restore()
        ckpt.save(step, dict(state, step=step))
        if not stop.requested:
            metrics = self._maybe_eval(state["params"], state["mstate"]) or metrics
        else:
            metrics["stopped_by_signal"] = 1.0
        metrics["step"] = step
        metrics["wall_time"] = time.time() - t0
        if writer:
            writer.write(step, {k: v for k, v in metrics.items() if k != "step"}, kind="final")
            writer.close()
        return metrics

    # ------------------------------------------------------------------ eval
    def _maybe_eval(self, params, mstate) -> Dict[str, float]:
        try:
            return self._run_eval(params, mstate)
        except FileNotFoundError:
            return {}

    def _run_eval(self, params, mstate) -> Dict[str, float]:
        eval_step = L.build_eval_step(self.model)
        acc = L.init_eval_acc(self.model, self.device)
        for batch in self._dataset("va", shuffle=False, epochs=1):
            acc = eval_step(params, mstate, acc, to_device(batch, self.device))
        res = L.finalize_eval(acc)
        print("INFO: eval:", " ".join(f"{k} = {v:.6f}" for k, v in res.items()))
        return res

    def _restore(self) -> Dict[str, Any]:
        return self.restore_or_init(CheckpointManager(self.model_dir, keep=self.cfg.keep_checkpoint_max))

    def evaluate(self) -> Dict[str, float]:
        ts = self._restore()
        return self._run_eval(ts["params"], ts["mstate"])

    def evaluate_loop(self) -> Dict[str, float]:
        """Continuous evaluator: poll model_dir for new checkpoints and
        evaluate each, until none has appeared for eval_loop_timeout
        seconds (the reference's dedicated evaluator role)."""
        cfg = self.cfg
        writer = MetricsWriter(self.model_dir, filename="eval_metrics.jsonl") if cfg.write_metrics else None
        ckpt = CheckpointManager(self.model_dir, keep=cfg.keep_checkpoint_max)
        last_step = None
        last_new = time.time()
        metrics: Dict[str, float] = {}
        while time.time() - last_new < cfg.eval_loop_timeout:
            step = ckpt.latest_step()
            if step is not None and step != last_step:
                ts = self.restore_or_init(ckpt)
                metrics = self._run_eval(ts["params"], ts["mstate"])
                metrics["step"] = step
                if writer:
                    writer.write(step, {k: v for k, v in metrics.items() if k != "step"}, kind="eval")
                last_step, last_new = step, time.time()
            else:
                time.sleep(cfg.eval_loop_secs)
        if writer:
            writer.close()
        return metrics

    # ----------------------------------------------------------------- infer
    def infer(self, out_path: Optional[str] = None) -> str:
        """Predict over the te* files -> pred.txt (one probability of the
        model's first prediction key a line, padding rows skipped), with
        the predict step and the serving lookup: K1 over the whole table
        on the card, the ids normalised as JAX's gather treats them. One
        process; the multi-process form waits for the multi-GPU port."""
        from tf_repos_tpu_torch.ops.sparse_rows import make_serving_lookup

        ts = self._restore()
        predict_step = L.build_predict_step(self.model, lookup=make_serving_lookup())
        out_path = out_path or os.path.join(self.cfg.data_dir, "pred.txt")
        key = self.model.prediction_keys[0]
        with open(out_path, "w") as f:
            for batch in self._dataset("te", shuffle=False, epochs=1):
                preds = predict_step(ts["params"], ts["mstate"], to_device(batch, self.device))[key]
                for p, m in zip(preds.cpu().numpy(), batch["mask"]):
                    if m > 0:
                        f.write(f"{p:f}\n")
        return out_path

    # ---------------------------------------------------------------- export
    def export(self) -> str:
        from tf_repos_tpu_torch.serve.export import export_servable

        cfg = self.cfg
        ts = self._restore()
        return export_servable(cfg.servable_model_dir or os.path.join(self.model_dir, "servable"),
                               self.model, ts["params"], ts["mstate"])


def run_task(cfg: Config) -> Dict[str, float] | str:
    """CLI entry: task_type dispatch."""
    echo_config(cfg)
    h = Harness(cfg)
    if cfg.clear_existing_model and cfg.task_type == "train":
        clear_existing_model(cfg.resolved_model_dir())
    tasks = {"train": h.train, "eval": h.evaluate, "eval_loop": h.evaluate_loop,
             "infer": h.infer, "export": h.export}
    if cfg.task_type not in tasks:
        raise ValueError(f"unknown task_type {cfg.task_type!r}")
    return tasks[cfg.task_type]()
