"""The system under test: the port's lazy-sparse training step as the
CLI builds it under ``--sparse_table_update --fused_table
--pallas_expand`` (train/harness.py), with its host chain, driven from
the benchmark's own weights and batches. Everything here that touches
the port goes through its public functions; the port is imported when
a Program is made, never when this module is."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.common import B1, named_leaves

CONFIG_KEYS = ("source", "reference", "reduced", "assumed")
# what a planted fault does (the benchmark's own runs plant none)
FAULTS = ("state_unchanged", "half_batch", "attention_unchanged")
ATTENTION = ("att_mlp", "att_out")


def port_config(config: Dict):
    from tf_repos_tpu_torch.config import Config

    return Config(**{k: v for k, v in config.items() if k not in CONFIG_KEYS})


def host_chain(cfg, model):
    """The CLI's training-split map chain (Harness input pipeline): the
    multi-hot width bucketer, the COO packer (with the compact segment
    stream for the sorted-stream kernels), then the dedup mapper."""
    from tf_repos_tpu_torch.data.ragged import MH_PAIRS
    from tf_repos_tpu_torch.data.sparse_batch import MhCooPacker, MhPadBucketer, SparseBatchMapper

    stages = []
    if cfg.mh_bucket != "off":
        stages.append(MhPadBucketer(MH_PAIRS, cfg.mh_bucket))
    if cfg.mh_coo:
        floor = max(cfg.mh_coo_floor, 1) if cfg.mh_coo_floor else 1024
        stages.append(MhCooPacker(
            model.mh_coo_groups(), floor=floor,
            combine=cfg.mh_coo_combine and model.coo_combine_ok(),
            cdest_aux=cfg.pallas_expand and model.wants_sorted_seg(),
            sorted_aux=cfg.coo_sorted_bwd and cfg.pallas_expand and model.wants_sorted_aux()))
    stages.append(SparseBatchMapper(model.sparse_slots(), pad_mode=cfg.sparse_pad_mode))

    def chain(batch):
        batch = dict(batch)
        for stage in stages:
            batch = stage(batch)
        return batch
    return chain


class Program:
    """One training-step object: the model, its parameters and optimizer
    state, built once from the seed's weights; ``step`` is the call the
    window drives. ``fault`` plants one of FAULTS (for the checks of the
    check); ``param_dtype`` overrides the configuration's table dtype
    (the bf16-store control)."""

    def __init__(self, config: Dict, ref, seed: int, device, fault: Optional[str] = None,
                 param_dtype: Optional[str] = None):
        from tf_repos_tpu_torch.models import create_model
        from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
        from tf_repos_tpu_torch.train import sparse as SP
        from tf_repos_tpu_torch.train.optimizers import make_optimizer

        if fault is not None and fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}; choose from {FAULTS}")
        if param_dtype:
            config = dict(config, param_dtype=param_dtype)
        self.cfg = cfg = port_config(config)
        if not (cfg.sparse_table_update and cfg.fused_table):
            raise ValueError("the benchmark drives the lazy step on the fused w|m|v store")
        self.device, self.fault = device, fault
        self.model = model = create_model(cfg)
        self.chain = host_chain(cfg, model)
        params, self.mstate = ref.init_params(config, seed, device)
        if cfg.param_dtype == "bfloat16":
            params = SP.cast_tables(model, params, torch.bfloat16)
        self.tables = list(model.sparse_slots())
        tx = make_optimizer(cfg.optimizer, cfg.learning_rate)
        sopt = SP.make_sparse_row_optimizer(cfg.optimizer, cfg.learning_rate, fused_table=True,
                                            catchup=cfg.sparse_catchup, dma_scatter=cfg.dma_scatter)
        self.opt = SP.init_opt_state(model, tx, sopt, params)
        self.params = params
        if fault == "state_unchanged":
            tx.update_ = lambda *a, **k: None
            sopt.apply = lambda aux, *a, **k: sopt.table(aux)
        elif fault == "attention_unchanged":
            tx.update_ = _without(tx.update_, [t for n, t in named_leaves(params)
                                               if n.split(".")[0] in ATTENTION])
        self._step = SP.build_sparse_train_step(
            model, tx, sopt, lookup=make_expand_lookup() if cfg.pallas_expand else None)
        self.sr = (torch.Generator(device=device).manual_seed(int(seed) % (1 << 63) ^ 0x5EED)
                   if cfg.param_dtype == "bfloat16" else None)

    def map(self, raw: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The host chain on one raw batch (half its rows masked out under
        the half_batch fault, so the loss is the mean over the rest)."""
        mapped = self.chain(raw)
        if self.fault == "half_batch":
            mask = np.array(mapped["mask"], np.float32)
            mask[mask.shape[0] // 2:] = 0.0
            mapped["mask"] = mask
        return mapped

    def stage(self, mapped: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host arrays -> tensors on the card, dtypes kept (harness.to_device)."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device) for k, v in mapped.items()}

    def step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        self.params, self.opt, self.mstate, loss = self._step(
            self.params, self.opt, self.mstate, batch, None, self.sr)
        return loss

    # --------------------------------------------------------- readings
    def dense_leaves(self) -> Dict[str, torch.Tensor]:
        return {n: t for n, t in named_leaves(self.params) if n not in self.tables}

    def first_grad_norms(self) -> Dict[str, float]:
        """Each leaf's gradient at step 1 as the optimizer got it, worked
        out from its state after that one step: Adam's first moment is
        then (1 - b1) * g, in the dense state and in the m columns of the
        fused w|m|v store."""
        out = {}
        for n, m in named_leaves(self.opt["dense"]["mu"]):
            out[n] = float(torch.linalg.vector_norm(m.float())) / (1.0 - B1)
        for t in self.tables:
            aux = self.opt["sparse"][t]
            k = aux["k"]
            m = aux["wmv"][:-1, k:2 * k].float()
            out[t] = float(torch.linalg.vector_norm(m)) / (1.0 - B1)
        return out

    def change_norms(self, start: Dict) -> Dict[str, float]:
        """Norm of each leaf's change from ``start`` (the seed's weights),
        as the store holds the leaf for the next step."""
        out = {}
        for n, x in named_leaves(self.params):
            out[n] = float(torch.linalg.vector_norm(x.float() - start[n]))
        return out


def _without(update_, frozen: List[torch.Tensor]):
    """The dense update with a nought gradient for the ``frozen`` leaves:
    Adam's state for them stays zero and they never move."""
    if not frozen:
        raise ValueError("the model has no attention leaves to leave unchanged")
    ids = {id(t) for t in frozen}

    def update(params, grads, state):
        update_(params, [torch.zeros_like(g) if id(p) in ids else g for p, g in zip(params, grads)], state)
    return update


def first_steps(prog: Program, ref, config: Dict, seed: int, staged: List, n: int = 3) -> Dict:
    """The program's first ``n`` steps through the window's own call on
    the first ``n`` batches of the pool, with the readings the check
    compares: each step's loss, each leaf's gradient norm at step 1 and
    each leaf's change after step n."""
    out = {"loss": []}
    for i in range(n):
        out["loss"].append(float(prog.step(staged[i])))
        if i == 0:
            out["grad"] = prog.first_grad_norms()
    start, _ = ref.init_params(config, seed, prog.device)
    out["change"] = prog.change_norms(dict(named_leaves(start)))
    del start
    return out
