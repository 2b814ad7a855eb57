"""Trainer harness (counterpart of the JAX package's train/harness.py) on
one device: the libsvm models (LR, DeepFM, the PNN family, NFM, AFM,
DCN, DeepMVM), Wide&Deep on Criteo CSV lines, and ESMM and DIN on
Ali-CCP sample lines.

  train     -> train loop with periodic eval (eval_throttle_secs),
               checkpoints (torch.save under model_dir), a final eval on
               the va* split
  eval      -> one eval pass over the va* files from the newest checkpoint
  eval_loop -> poll model_dir for new checkpoints and evaluate each
               (eval_loop_secs, eval_loop_timeout; eval_metrics.jsonl
               under --write_metrics)
  infer     -> pred.txt from the te* files with the predict step and the
               serving lookup (K1 over the whole table); under several
               hosts the te* files round robin over the hosts, merged
               into the one-process pred.txt
  export    -> a versioned servable (serve/export.py) under
               servable_model_dir or <model_dir>/servable

--optimizer picks Adam, Adagrad, ftrl, Momentum, GD/SGD or the canned
wdl composite (train/optimizers.py; wdl's rates come from the model or
--model_type). The step is the lazy sparse step (train/sparse.py) under
--sparse_table_update, with the optimizer's row form (wdl has none),
the hand-written expand/accumulate kernels as its inner lookup under
--pallas_expand and the row-scatter write-back under --dma_scatter
(--fused_table and --dma_scatter: Adam only); the dense step otherwise,
whose table gradient goes through the field-block scatter kernel under
--field_blocks. A model that declares no sparse tables (Wide&Deep)
takes the dense step under --sparse_table_update, with a warning, as in
the JAX package. LR's 1-D table takes the lazy row forms without the
fused store, or the dense step: --fused_table and --pallas_expand raise
for it.
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
--param_dtype=bfloat16 (with --sparse_table_update) stores the sparse
tables and every row store of the lazy optimizer in bf16, written back
with stochastic rounding from a generator of its own (seeded from
--seed, on the step's device); eval, eval_loop, infer and export read
f32 copies of the tables. --fused_moments keeps Adam's m|v (FTRL's n|z)
in one [V,2K] row store. --slim_transfer (libsvm with --static_fields,
or Ali-CCP) encodes every split's batches to the slim wire on the host
(data/slim_wire.py; under --map_workers the Ali-CCP encoder joins the
training split's map chain) and SlimWireModel decodes them on the
device; export writes the wrapped model.
--steps_per_dispatch K runs as a plain loop of K steps.

The mesh (--mesh_data x --mesh_model, parallel/): run_task spawns one
process a mesh position when the mesh has more than one (JAX's rule:
none when one card is visible, or at --mesh_data=1 --mesh_model<=1; on
--device=cpu every requested position is a process), and each rank runs
this harness with its Mesh: the tables row-sharded over "model", the
batch split over "data", the sharded dense or lazy step
(parallel/step.py, parallel/sparse_step.py; --field_blocks is ignored
there, as in JAX). Every rank reads the whole global batch stream and
keeps its data slice. Rank 0 alone writes logs, metrics, checkpoints
(the single-device state assembled from the shards, so any mesh or one
device restores them), pred.txt and exports. --check_numerics raises
FloatingPointError at the first step that makes a NaN, and
--profile_steps traces steps [profile_start_step, +profile_steps) with
torch.profiler into <model_dir>/profile (utils/observability.py).

Several hosts (--dist_mode=2 --worker_hosts --task_index, one CLI process
a host, parallel/distributed.py): the mesh's data axis spans the hosts
(host h holds data rows [h*D/H, (h+1)*D/H)) and --batch_size is per
host. The tr files are split round robin over the hosts (va files are
not: every host reads the same stream; te files only in infer), each
host's ranks read the host's stream, pack the COO streams over the D/H
local data shards, and in _place, on the main thread, take the
cross-host uid union (data/sparse_batch.GlobalUidsUnion) before keeping
their slice; synchronized_iterator keeps the hosts' streams to one
length. A SIGTERM to a launcher reaches its ranks, and every rank of
the mesh stops at the same eval-decision boundary (GracefulStop's OR
over the mesh); the eval verdict is the chief's (_agree); the chief
writes checkpoints to the shared model_dir."""

from __future__ import annotations

import json
import os
import shutil
import signal
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from tf_repos_tpu_torch.config import Config, echo_config
from tf_repos_tpu_torch.data.csv import CsvDataset
from tf_repos_tpu_torch.data.libsvm import LibsvmDataset, glob_input_files
from tf_repos_tpu_torch.data.pipeline import (
    Prefetcher,
    parallel_mapped_batches,
    shard_files_for_host,
    synchronized_iterator,
)
from tf_repos_tpu_torch.data.ragged import MH_PAIRS, AliccpDataset
from tf_repos_tpu_torch.data.slim_wire import (
    MHC_HI,
    MHC_LO,
    AliccpSlimEncoder,
    SharedWireState,
    SlimWireModel,
    aliccp_encoding_batches,
    decode_aliccp_batch,
    encoding_batches,
)
from tf_repos_tpu_torch.data.sparse_batch import (
    MHC_CDEST,
    MHC_CIDX,
    MHC_DEST,
    MHC_IDX,
    MHC_PERM,
    MHC_SROWS,
    MHC_W,
    UIDS_PREFIX,
    GlobalUidsUnion,
    MhCooPacker,
    MhPadBucketer,
    SparseBatchMapper,
    mapped_batches,
)
from tf_repos_tpu_torch.models import create_model, input_format
from tf_repos_tpu_torch.parallel.distributed import (
    host_index,
    host_max,
    init_distributed,
    is_chief,
)
from tf_repos_tpu_torch.parallel.mesh import Mesh, mesh_devices
from tf_repos_tpu_torch.parallel.sparse_step import (
    ShardedSparseState,
    build_sharded_sparse_train_step,
)
from tf_repos_tpu_torch.parallel.step import (
    ShardedState,
    build_sharded_eval_step,
    build_sharded_predict_step,
    build_sharded_train_step,
    fold_seed,
    slice_batch,
)
from tf_repos_tpu_torch.train import loop as L
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.checkpoint import CheckpointManager, clear_existing_model
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils.observability import (
    MetricsWriter,
    enable_nan_checks,
    profile_trace,
    span,
)
from tf_repos_tpu_torch.utils.platform import resolve_device
from tf_repos_tpu_torch.utils.tree import tree_map


def check_supported(cfg: Config) -> None:
    """Reject flag values that name no path."""
    if cfg.compute_dtype not in ("float32", "f32", "", "bfloat16", "bf16"):
        raise ValueError(f"unsupported compute_dtype {cfg.compute_dtype!r}")


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """Host arrays -> tensors on ``device``, dtypes kept (the slim wire's
    uint16 and uint8 too: the decode widens them on the device). A
    read-only array (a view of the packed cache's memmap) is copied
    first: torch.from_numpy would alias it, and on the CPU the tensor
    would be that read-only memory."""
    def tensor(v):
        a = np.ascontiguousarray(v)
        return torch.from_numpy(a if a.flags.writeable else a.copy()).to(device)

    return {k: tensor(v) for k, v in batch.items()}


class GracefulStop:
    """SIGTERM -> finish the current step, checkpoint, stop.

    On a mesh the signal reaches the ranks at different times (and under
    several hosts only one host's ranks), and a rank that stops alone
    deadlocks the others' collectives: ``agree_any`` (the mesh's OR over
    every rank) is consulted only at the eval-decision boundaries, which
    every rank reaches at the same step, so all stop at the same one."""

    def __init__(self, install: bool, decision_steps: int = 1, k: int = 1, agree_any=None):
        self.requested = False
        self.stopped = False
        self._decision_steps = max(decision_steps, 1)
        self._k = max(k, 1)
        self._agree_any = agree_any
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

    def should_stop(self, step: int) -> bool:
        if self._agree_any is None:
            self.stopped = self.requested
        elif step % self._decision_steps < self._k:
            self.stopped = bool(self._agree_any(self.requested))
        return self.stopped

    def restore(self) -> None:
        if self._installed:
            signal.signal(signal.SIGTERM, self._prev)


def mesh_shape(cfg: Config, hosts: int = 1) -> Optional[Tuple[int, int]]:
    """(data, model) of the mesh the CLI spawns, or None for one process:
    JAX's rule (no mesh when one card is visible, or at --mesh_data=1
    --mesh_model<=1; --mesh_data=-1 takes every visible card), with every
    requested position a process on --device=cpu (-1 counts one there).
    Over several hosts always a mesh, --mesh_data=-1 taking every host's
    visible cards (one data row a host on the CPU)."""
    model = max(cfg.mesh_model, 1)
    if hosts > 1:
        if cfg.mesh_data > 0:
            return cfg.mesh_data, model
        if torch.device(cfg.device).type == "cpu":
            return hosts, model
        return hosts * max(torch.cuda.device_count() // model, 1), model
    if torch.device(cfg.device).type == "cpu":
        data = max(cfg.mesh_data, 1)
    else:
        n = torch.cuda.device_count()
        if (n == 1 or cfg.mesh_data == 1) and cfg.mesh_model <= 1:
            return None
        data = cfg.mesh_data if cfg.mesh_data > 0 else max(n // model, 1)
    return None if data * model == 1 else (data, model)


def check_mesh(cfg: Config, data: int, hosts: int = 1) -> None:
    """What a mesh refuses, before any rank starts: a data axis that does
    not divide over the hosts, and a (per-host) batch that does not
    split over a host's data coordinates."""
    if data % hosts:
        raise ValueError(f"the data axis {data} does not divide over {hosts} hosts")
    if cfg.batch_size % (data // hosts):
        raise ValueError(
            f"batch size {cfg.batch_size} not divisible by the data-mesh size {data // hosts}"
            + (f" (the data coordinates of one of {hosts} hosts)" if hosts > 1 else "")
        )


class Harness:
    def __init__(self, cfg: Config, mesh: Optional[Mesh] = None):
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.hosts = mesh.hosts if mesh is not None else 1
        if mesh is not None:
            check_mesh(cfg, mesh.data, mesh.hosts)
        self.device = mesh.device if mesh is not None else resolve_device(cfg.device)
        self.chief = is_chief()
        self.model = create_model(cfg)
        if cfg.slim_transfer:
            fmt = input_format(self.model)
            if fmt == "libsvm":
                if cfg.static_fields <= 0:
                    raise ValueError(
                        "--slim_transfer requires --static_fields>0 (it "
                        "reconstructs the constant-id continuous block from "
                        "the same Criteo layout contract)"
                    )
                self.model = SlimWireModel(self.model)
            elif fmt == "aliccp":
                self.model = SlimWireModel(self.model, decode=decode_aliccp_batch)
            else:
                raise ValueError(
                    "--slim_transfer supports libsvm and aliccp input "
                    f"formats (model {self.model.name} reads {fmt})"
                )
        # the canned wdl composite derives its rates from the model_type
        wdl_type = (cfg.model.lower() if cfg.model.lower() in ("wide", "deep")
                    else (cfg.model_type or "wide_n_deep").lower())
        self.tx = make_optimizer(cfg.optimizer, cfg.learning_rate, wdl_type)
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
            slots = self.model.sparse_slots()
            if slots:
                self._sparse_slots = slots
            else:
                print(
                    f"WARNING: --sparse_table_update: {self.model.name} "
                    "declares no sparse tables; using the dense path"
                )
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
        if self._mh_bucket and self.hosts > 1 and not cfg.sparse_table_update:
            raise ValueError(
                "--mh_bucket under multi-host requires "
                "--sparse_table_update: every host must dispatch "
                "identical shapes, and the cross-host width consensus "
                "rides GlobalUidsUnion's main-thread collectives"
            )
        self._table_dtype = None
        if cfg.param_dtype not in ("float32", "f32", ""):
            if cfg.param_dtype not in ("bfloat16", "bf16"):
                raise ValueError(f"unsupported param_dtype {cfg.param_dtype!r}")
            if self._sparse_slots is None:
                raise ValueError(
                    "--param_dtype=bfloat16 requires --sparse_table_update "
                    "(bf16 tables are written with stochastic rounding, "
                    "which lives in the lazy sparse-update path)"
                )
            self._table_dtype = torch.bfloat16
        self._sopt = None
        if self._sparse_slots is not None:
            self._sopt = SP.make_sparse_row_optimizer(
                cfg.optimizer, cfg.learning_rate, fused_moments=cfg.fused_moments,
                fused_table=cfg.fused_table, catchup=cfg.sparse_catchup,
                dma_scatter=cfg.dma_scatter,
            )
        # the cross-host uid union (_place, on the main thread)
        self._uids_union = None
        if self._sparse_slots is not None and self.hosts > 1:
            self._uids_union = GlobalUidsUnion(
                self._sparse_slots, bucketed_pairs=MH_PAIRS if self._mh_bucket else ())
        self._train_step = None
        self._sharded = None
        if mesh is not None:
            self._sharded = (ShardedState(self.model, mesh) if self._sopt is None
                             else ShardedSparseState(self.model, self._sopt, mesh))

    # ---------------------------------------------------------- state init
    def init_train_state(self) -> Dict[str, Any]:
        """The initial state; under a mesh made whole on the CPU, then cut
        into the rank's shards."""
        if self._sharded is None:
            return dict(self._init_whole(self.device), step=0)
        return dict(self._sharded.shard(self._init_whole(torch.device("cpu"))), step=0)

    def _init_whole(self, dev: torch.device) -> Dict[str, Any]:
        """The single-device initial state on ``dev``."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        params, mstate = self.model.init(gen)
        params = tree_map(lambda t: t.to(dev), params)
        mstate = tree_map(lambda t: t.to(dev), mstate)
        if self._sopt is not None:
            if self._table_dtype is not None:
                # bf16 tables, so every row store made from them is bf16
                params = SP.cast_tables(self.model, params, self._table_dtype)
            opt_state = SP.init_opt_state(self.model, self.tx, self._sopt, params)
        else:
            opt_state = self.tx.init(params)
        return {"params": params, "opt_state": opt_state, "mstate": mstate}

    def restore_or_init(self, ckpt: CheckpointManager, step: Optional[int] = None) -> Dict[str, Any]:
        """The checkpoint of ``step`` or the newest (the single-device
        state, from any mesh), cut into the rank's shards under a mesh;
        else the initial state."""
        if self._sharded is None:
            restored = ckpt.restore(self.device, step)
            return restored if restored is not None else self.init_train_state()
        restored = ckpt.restore("cpu", step)
        if restored is None:
            return self.init_train_state()
        step = restored.pop("step", 0)
        return dict(self._sharded.shard(restored), step=step)

    def _save(self, ckpt: CheckpointManager, step: int, state: Dict[str, Any]) -> None:
        """Checkpoint the single-device state: under a mesh assembled from
        the shards (every rank takes part) and written by the chief."""
        if self._sharded is not None:
            state = self._sharded.assemble(state)
        if self.chief:
            ckpt.save(step, dict(state, step=step))
        if self.mesh is not None:
            self.mesh.barrier()

    def _agree(self, value: int) -> int:
        """The chief's ``value`` on every rank (a decision taken on one
        clock, so that every rank enters the same collectives)."""
        if self.mesh is None:
            return value
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        return int(self.mesh.broadcast(t).item())

    def _place(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """A host batch on the device: the data rank's slice under a mesh,
        after the cross-host uid union (a collective: the main thread,
        batches in stream order) under several hosts."""
        if self._uids_union is not None and any(k.startswith(UIDS_PREFIX) for k in batch):
            batch = self._uids_union(batch)
        if self.mesh is not None:
            batch = slice_batch(batch, self.mesh)
        return to_device(batch, self.device)

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
        if not cfg.field_blocks or self._sparse_slots is not None or self.mesh is not None:
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
        """Unified signature: (state, device_batch, generator, sr_generator)
        -> (state, loss); ``generator`` drives dropout, ``sr_generator``
        the stochastic rounding of bf16 row stores (the lazy step only)."""
        if self._train_step is not None:
            return self._train_step
        if self.mesh is not None and self._sopt is not None:
            inner = build_sharded_sparse_train_step(
                self.model, self.tx, self._sopt, self.mesh, self._sharded.vocab,
                inner_lookup=self.inner_lookup(),
            )
        elif self.mesh is not None:
            dense = build_sharded_train_step(self.model, self.tx, self.mesh)

            def inner(p, o, m, b, g, sr):  # the dense step rounds nothing
                return dense(p, o, m, b, g)
        elif self._sopt is not None:
            inner = SP.build_sparse_train_step(
                self.model, self.tx, self._sopt, lookup=self.inner_lookup()
            )
        else:
            dense = L.build_train_step(self.model, self.tx, lookup=self.field_block_lookup())

            def inner(p, o, m, b, g, sr):  # the dense step rounds nothing
                return dense(p, o, m, b, g)

        def step(state, batch, generator, sr_generator=None):
            p, o, m, loss = inner(
                state["params"], state["opt_state"], state["mstate"], batch, generator,
                sr_generator,
            )
            return {"params": p, "opt_state": o, "mstate": m}, loss

        self._train_step = enable_nan_checks(step) if self.cfg.check_numerics else step
        return self._train_step

    # ------------------------------------------------------------- datasets
    def _dataset(self, split: str, *, shuffle: bool, epochs: int) -> Iterable:
        """split in {tr, va, te}: the reader of the model's input format,
        then the host map chain (width bucketer on every split; on the
        training split of the sparse step the COO packer and the dedup
        mapper), on --map_workers threads for the training split, behind
        a Prefetcher thread. Under several hosts the tr files are the
        host's shard, and synchronized_iterator holds every host's stream
        to the shortest's length."""
        cfg = self.cfg
        fmt = input_format(self.model)
        files = self._glob_split(split, shuffle=shuffle)
        if self.hosts > 1 and split == "tr":
            files = shard_files_for_host(files, host_index(), self.hosts)
        if not files:
            raise FileNotFoundError(f"no {split}* {fmt} input files in {cfg.data_dir}")
        if self.mesh is not None and cfg.packed_cache and shuffle:
            self._settle_packed_cache(files, fmt)
        ds: Iterable = self._build_reader(files, fmt, shuffle=shuffle, epochs=epochs)
        factories = []
        slim_in_chain = False
        if self._mh_bucket:
            # live-width slicing first: smaller id arrays for everything after
            factories.append(lambda: MhPadBucketer(MH_PAIRS, cfg.mh_bucket))
        if split == "tr" and self._sparse_slots is not None:
            if cfg.mh_coo:
                combine = self._coo_combine_active()
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
                # a kernel under --pallas_expand. Neither under
                # --slim_transfer: the device rebuilds the compact stream
                # from the wire's counts, and the sorted stream (8 B a
                # slot) would undo the wire's saving, so the COO lookup
                # keeps its plain backward there
                groups = self.model.mh_coo_groups()
                floor = max(cfg.mh_coo_floor, 1) if cfg.mh_coo_floor else 1024
                slim = cfg.slim_transfer
                cdest = cfg.pallas_expand and self.model.wants_sorted_seg() and not slim
                saux = (cfg.coo_sorted_bwd and cfg.pallas_expand
                        and self.model.wants_sorted_aux() and not slim)
                # the host's own data shards
                n_data = self.mesh.local_data if self.mesh is not None else 1
                factories.append(lambda: MhCooPacker(groups, floor=floor, combine=combine,
                                                     cdest_aux=cdest, sorted_aux=saux,
                                                     n_data=n_data))
            slots, pad_mode = self._sparse_slots, cfg.sparse_pad_mode
            factories.append(lambda: SparseBatchMapper(slots, pad_mode=pad_mode))
            if cfg.slim_transfer and cfg.map_workers > 1 and fmt == "aliccp" and self.hosts == 1:
                # the encoder on the worker pool too, with one wire state
                # for the pool (per-worker first-batch commits would
                # diverge); one host only: across hosts it runs on the
                # prefetch thread, uncompressed, ahead of the union
                enc, shared = self._aliccp_encoder_args(), SharedWireState()
                factories.append(lambda: AliccpSlimEncoder(shared=shared, **enc))
                slim_in_chain = True
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
        if cfg.slim_transfer and not slim_in_chain:
            ds = self._slim_wrap(ds)
        it: Iterable = Prefetcher(ds, size=cfg.prefetch_batches)
        if self.hosts > 1:
            # every host dispatches the same number of collective steps
            it = synchronized_iterator(it)
        return it

    def _settle_packed_cache(self, files: List[str], fmt: str) -> None:
        """Under a mesh every rank of a host reads the host's files, and a
        --packed_cache build shuffles other batches than a cache read
        (parsed blobs against the cache's row slices, each permuted): a
        rank that opened a file after another had committed its cache
        would train on another stream. So the host's first rank completes
        every cache first (one pass, which parses only the files without
        one) and every rank then reads the caches."""
        if self.mesh.m == 0 and self.mesh.d_local == 0:
            for _ in self._build_reader(files, fmt, shuffle=False, epochs=1):
                pass
        self.mesh.barrier()

    def _glob_split(self, split: str, *, shuffle: bool = False) -> List[str]:
        """The split's input files of the model's format (shuffled by
        --seed for the training split: the same order on every host)."""
        cfg = self.cfg
        fmt = input_format(self.model)
        if fmt == "aliccp":
            return [f for f in glob_input_files(cfg.data_dir, f"{split}*", shuffle=shuffle, seed=cfg.seed)
                    if not f.endswith((".libsvm", ".csv"))]
        return glob_input_files(cfg.data_dir, f"{split}*{fmt}", shuffle=shuffle, seed=cfg.seed)

    def _coo_combine_active(self) -> bool:
        """--mh_coo_combine applies only where every COO consumer is
        linear in w; the slim encoder keys off it too (a combined w is a
        count, not the live mask)."""
        return bool(self.cfg.mh_coo and self.cfg.mh_coo_combine and self.model.coo_combine_ok())

    def _aliccp_encoder_args(self) -> Dict[str, Any]:
        """The Ali-CCP encoder's arguments: the id bound of unmapped
        batches, the COO groups (the split idx and the counts form on one
        host: across hosts the union rewrites the raw idx and re-pads the
        dest), and whether the COO w may be dropped."""
        cfg = self.cfg
        return dict(vocab=cfg.feature_size, compress_coo=self.hosts == 1,
                    n_groups=len(self.model.mh_coo_groups()) if cfg.mh_coo else 0,
                    drop_w_ok=not self._coo_combine_active())

    def _slim_wrap(self, ds: Iterable) -> Iterable:
        """The slim wire encoder over a split's batches (on the prefetch
        thread); SlimWireModel decodes them in the step."""
        if input_format(self.model) == "aliccp":
            return aliccp_encoding_batches(ds, **self._aliccp_encoder_args())
        return encoding_batches(ds, self.cfg.static_fields)

    def _build_reader(self, files: List[str], fmt: str, *, shuffle: bool, epochs: int) -> Iterable:
        cfg = self.cfg
        common = dict(batch_size=cfg.batch_size, num_epochs=epochs, perform_shuffle=shuffle,
                      shuffle_buffer=cfg.shuffle_buffer, seed=cfg.seed,
                      packed_cache=cfg.packed_cache)
        if fmt == "aliccp":
            return AliccpDataset(files, multi_hot_pad=cfg.multi_hot_pad, **common)
        if fmt == "csv":
            return CsvDataset(files, **common)
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
                          MHC_PERM: 0, MHC_CIDX: 0, MHC_SROWS: 0,
                          # the slim wire's split idx (lo = hi = 0 is idx 0)
                          MHC_LO: 0, MHC_HI: 0})
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
        if K > 1 and cfg.profile_steps:
            print("WARNING: --profile_steps requires steps_per_dispatch=1 "
                  "(the trace window brackets individual dispatches)")
        # dropout's stream is the data rank's own (fold_seed); the
        # stochastic rounding's is the same on every rank, so dropout's
        # draws do not shift it. Each is None where nothing draws from it
        # (every keep 1; an f32 store): a step that draws nothing may
        # replay as a CUDA graph (train/step_graph.py)
        d = self.mesh.d if self.mesh is not None else 0
        gen = (torch.Generator(device=self.device).manual_seed(fold_seed(cfg.seed + 1, d))
               if any(k < 1.0 for k in cfg.dropout_list) else None)
        sr_gen = (torch.Generator(device=self.device).manual_seed(cfg.seed + 2)
                  if cfg.param_dtype in ("bfloat16", "bf16") else None)
        writer = MetricsWriter(self.model_dir) if cfg.write_metrics and self.chief else None
        # on a mesh every rank stops at the same decision boundary
        stop = GracefulStop(cfg.graceful_shutdown, cfg.eval_decision_steps, K,
                            agree_any=self.mesh.any_rank if self.mesh is not None else None)
        profiler = None
        losses: List[torch.Tensor] = []
        t0 = time.time()
        last_log, last_eval, last_log_step = t0, t0, step
        metrics: Dict[str, float] = {}
        group: List[Dict[str, np.ndarray]] = []

        def run_group(state, batches):
            for b in batches:
                state, loss = train_step(state, self._place(b), gen, sr_gen)
                losses.append(loss)
            return state

        batches = iter(self._dataset("tr", shuffle=True, epochs=cfg.num_epochs))
        while True:
            with span("input.wait"):  # the host input's wait, in a profile's window
                batch = next(batches, None)
            if batch is None:
                break
            if K == 1 and cfg.profile_steps and step == cfg.profile_start_step:
                profiler = profile_trace(os.path.join(self.model_dir, "profile"), self.device)
                profiler.__enter__()
            group.append(batch)
            if len(group) < K:
                continue
            state = run_group(state, group)
            step += len(group)
            group = []
            if profiler and step >= cfg.profile_start_step + cfg.profile_steps:
                profiler.__exit__()
                profiler = None
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
                self._save(ckpt, step, state)
            if cfg.eval_throttle_secs and step % cfg.eval_decision_steps < K:
                # (a negative throttle evals at every decision boundary);
                # under a mesh the chief's clock decides for every rank
                if self._agree(int(time.time() - last_eval > cfg.eval_throttle_secs)):
                    metrics = self._maybe_eval(state["params"], state["mstate"])
                    if writer and metrics:
                        writer.write(step, metrics, kind="eval")
                    last_eval = time.time()
            if stop.should_stop(step):
                print(f"INFO: graceful shutdown: checkpointing at step {step}")
                break
        if group and not stop.stopped:  # tail of an unfinished K-group
            state = run_group(state, group)
            step += len(group)
        if profiler:
            profiler.__exit__()
        stop.restore()
        self._save(ckpt, step, state)
        if not stop.stopped:
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

    def _f32_params(self, params):
        """Eval, infer and export read f32 tables (bf16 is a training
        storage format; the upcast is a one-off [V,K] copy)."""
        if self._table_dtype is None:
            return params
        return SP.upcast_tables_f32(self.model, params)

    def _run_eval(self, params, mstate) -> Dict[str, float]:
        params = self._f32_params(params)
        if self.mesh is not None:
            eval_step = build_sharded_eval_step(self.model, self.mesh)
        else:
            eval_step = L.build_eval_step(self.model)
        acc = L.init_eval_acc(self.model, self.device)
        for batch in self._dataset("va", shuffle=False, epochs=1):
            acc = eval_step(params, mstate, acc, self._place(batch))
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
        seconds (the reference's dedicated evaluator role). Under a mesh
        the chief's poll decides for every rank."""
        cfg = self.cfg
        writer = (MetricsWriter(self.model_dir, filename="eval_metrics.jsonl")
                  if cfg.write_metrics and self.chief else None)
        ckpt = CheckpointManager(self.model_dir, keep=cfg.keep_checkpoint_max)
        last_step = None
        last_new = time.time()
        metrics: Dict[str, float] = {}
        while self._agree(int(time.time() - last_new < cfg.eval_loop_timeout)):
            latest = ckpt.latest_step()
            step = self._agree(-1 if latest is None else latest)
            if step >= 0 and step != last_step:
                ts = self.restore_or_init(ckpt, step)
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
        model's first prediction key a line, padding rows skipped). On one
        device with the predict step and the serving lookup: K1 over the
        whole table on the card, the ids normalised as JAX's gather
        treats them. Under a mesh with the sharded predict step (every
        rank its data slice over its table shards), the predictions in
        global batch order, written by the chief; under several hosts
        _infer_multiprocess."""
        from tf_repos_tpu_torch.ops.sparse_rows import make_serving_lookup

        ts = self._restore()
        params = self._f32_params(ts["params"])
        if self.mesh is not None:
            predict_step = build_sharded_predict_step(self.model, self.mesh)
        else:
            predict_step = L.build_predict_step(self.model, lookup=make_serving_lookup())
        out_path = out_path or os.path.join(self.cfg.data_dir, "pred.txt")
        key = self.model.prediction_keys[0]
        if self.hosts > 1:
            return self._infer_multiprocess(out_path, params, ts["mstate"], predict_step, key)
        f = open(out_path, "w") if self.chief else None
        try:
            for batch in self._dataset("te", shuffle=False, epochs=1):
                preds = predict_step(params, ts["mstate"], self._place(batch))[key]
                if f is not None:
                    for p, m in zip(preds.cpu().numpy(), batch["mask"]):
                        if m > 0:
                            f.write(f"{p:f}\n")
        finally:
            if f is not None:
                f.close()
        return out_path

    def _infer_multiprocess(self, out_path: str, params, mstate, predict_step, key: str) -> str:
        """Infer over several hosts: the te* files round robin over the
        hosts, every host dispatching the same number of predict steps (a
        host whose files ran out feeds files[0]'s first batch as a
        template and writes nothing of it), the first rank of each host
        writing its host's rows of every batch into one part a file under
        ``<out_path>.parts``, and the chief merging the parts in glob
        order. Eval-mode predictions are per example (no dropout, the
        batch-norm running stats), so the merged file equals the
        one-process pred.txt although the batch boundaries differ. The
        model_dir and data_dir are the hosts' shared filesystem."""
        cfg = self.cfg
        mesh = self.mesh
        fmt = input_format(self.model)
        files = self._glob_split("te")
        if not files:
            raise FileNotFoundError(f"task_type=infer: no te* input files in {cfg.data_dir}")
        h, n = host_index(), self.hosts
        parts_dir = out_path + ".parts"
        if self.chief:
            os.makedirs(parts_dir, exist_ok=True)
            for f in os.listdir(parts_dir):
                os.remove(os.path.join(parts_dir, f))
        mesh.barrier()
        writer = mesh.m == 0 and mesh.d_local == 0

        def file_batches(path):
            # no width bucketer: the hosts' te batches keep their fixed
            # pads (nothing agrees their widths across hosts)
            ds: Iterable = self._build_reader([path], fmt, shuffle=False, epochs=1)
            return self._slim_wrap(ds) if cfg.slim_transfer else ds

        tmpl = next(iter(file_batches(files[0])))

        def my_work():
            for i in range(h, len(files), n):
                for b in file_batches(files[i]):
                    yield i, b

        it = my_work()
        pending = next(it, None)
        part_f, part_i = None, -1
        try:
            while int(host_max(np.int32(pending is not None))):
                i, b = pending if pending is not None else (-1, tmpl)
                preds = predict_step(params, mstate, self._place(b))[key]
                if pending is not None and writer:
                    bh = len(b["mask"])
                    local = preds[h * bh: (h + 1) * bh].cpu().numpy()
                    if i != part_i:
                        if part_f:
                            part_f.close()
                        part_i = i
                        part_f = open(os.path.join(parts_dir, f"part{i:05d}"), "w")
                    for p, m in zip(local, b["mask"]):
                        if m > 0:
                            part_f.write(f"{p:f}\n")
                pending = next(it, None)
        finally:
            if part_f:
                part_f.close()
        mesh.barrier()
        if self.chief:
            with open(out_path, "w") as out:
                for name in sorted(os.listdir(parts_dir)):
                    with open(os.path.join(parts_dir, name)) as pf:
                        out.write(pf.read())
            shutil.rmtree(parts_dir, ignore_errors=True)
        mesh.barrier()
        return out_path

    # ---------------------------------------------------------------- export
    def export(self) -> str:
        """The unpadded single-device servable, written by the chief (a
        checkpoint holds the single-device state on every mesh)."""
        from tf_repos_tpu_torch.serve.export import export_servable

        cfg = self.cfg
        out = cfg.servable_model_dir or os.path.join(self.model_dir, "servable")
        if not self.chief:
            self.mesh.barrier()
            return out
        if self.mesh is None:
            ts = self._restore()
        else:
            ckpt = CheckpointManager(self.model_dir, keep=cfg.keep_checkpoint_max)
            ts = ckpt.restore(self.device) or self._init_whole(self.device)
        # the wrapped model: the slim wire is a training transfer format,
        # not a serving signature
        model = self.model.inner if isinstance(self.model, SlimWireModel) else self.model
        path = export_servable(out, model, self._f32_params(ts["params"]), ts["mstate"])
        if self.mesh is not None:
            self.mesh.barrier()
        return path


def _dispatch(h: Harness, task_type: str) -> Dict[str, float] | str:
    tasks = {"train": h.train, "eval": h.evaluate, "eval_loop": h.evaluate_loop,
             "infer": h.infer, "export": h.export}
    if task_type not in tasks:
        raise ValueError(f"unknown task_type {task_type!r}")
    return tasks[task_type]()


def run_task_on_mesh(mesh: Mesh, cfg: Config) -> Dict[str, float] | str:
    """One mesh rank's task (parallel/launch.run_on_mesh and run_on_hosts
    call it). Under several hosts the chief clears the shared model_dir
    for --clear_existing_model before any rank reads it."""
    h = Harness(cfg, mesh)
    if mesh.hosts > 1 and cfg.clear_existing_model and cfg.task_type == "train":
        if h.chief:
            clear_existing_model(cfg.resolved_model_dir())
        mesh.barrier()
    return _dispatch(h, cfg.task_type)


def run_task(cfg: Config) -> Dict[str, float] | str:
    """CLI entry: task_type dispatch, on one process or on a spawned mesh
    (mesh_shape) with one card a rank, or the CPU for every rank; under
    --dist_mode=2 this host's ranks of the mesh over the hosts."""
    echo_config(cfg)
    check_supported(cfg)
    layout = init_distributed(cfg)
    if layout is not None and layout.count > 1:
        return _run_on_hosts(cfg, layout)
    shape = mesh_shape(cfg)
    if shape is None:
        h = Harness(cfg)
        if cfg.clear_existing_model and cfg.task_type == "train":
            clear_existing_model(cfg.resolved_model_dir())
        return _dispatch(h, cfg.task_type)
    data, model = shape
    check_mesh(cfg, data)
    if cfg.task_type not in ("train", "eval", "eval_loop", "infer", "export"):
        raise ValueError(f"unknown task_type {cfg.task_type!r}")
    if cfg.clear_existing_model and cfg.task_type == "train":
        clear_existing_model(cfg.resolved_model_dir())
    from tf_repos_tpu_torch.parallel.launch import run_on_mesh

    return run_on_mesh(run_task_on_mesh, (cfg,), data=data, model=model,
                       devices=mesh_devices(data, model, cfg.device))


def _run_on_hosts(cfg: Config, layout) -> Dict[str, float] | str:
    """This host's part of the mesh over ``layout``'s hosts."""
    data, model = mesh_shape(cfg, layout.count)
    check_mesh(cfg, data, layout.count)
    if cfg.task_type not in ("train", "eval", "eval_loop", "infer", "export"):
        raise ValueError(f"unknown task_type {cfg.task_type!r}")
    from tf_repos_tpu_torch.parallel.launch import run_on_hosts

    return run_on_hosts(run_task_on_mesh, (cfg,), data=data, model=model,
                        devices=mesh_devices(data // layout.count, model, cfg.device),
                        hosts=layout.hosts, task_index=layout.index)
