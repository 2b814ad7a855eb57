#!/usr/bin/env python3
"""Chip smoke of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py              # what the checks run
    python3 chip_smoke.py --profile    # adds torch.profiler breakdowns of the bare steps
                                       # (the zoo's too)
    python3 chip_smoke.py --profile --trace=PATH   # and writes their Chrome traces
                                                   # (PATH, and PATH with _esmm, _din,
                                                   # _zoo_<model>...)
    python3 chip_smoke.py --only=multihost         # phase 7 alone (writes the main
                                                   # paths' files itself; no result line)
    python3 chip_smoke.py --only=serving_load      # phase 8 alone (writes phase 7e's
                                                   # surrogate itself; no result line)
    python3 chip_smoke.py --only=att_unit          # the fused attention unit alone
                                                   # (phase 3; no result line)
    python3 chip_smoke.py --only=step_graph        # the bare DeepFM and DIN steps as
                                                   # CUDA graphs against eager, and
                                                   # the DeepFM and DIN trajectories
                                                   # (phases 4 and 5; no result line)

Four main paths, each driven through the CLI with every launch counter
set to 0 just before and read just after, then serving from their
checkpoints (K1 over the whole table, its counter likewise): DeepFM (the lazy-sparse step
on K1 expand_rows / K2 accumulate_rows), ESMM with --mh_coo
--dma_scatter (which adds K3 coo_pool_rows / K4 coo_accumulate_rows and
the K7 dma_row_scatter write-back), DIN attention with --mh_coo (K1, K2,
K5 sorted_segsum, K6 sorted_expand, and the fused attention unit of
ops/att_unit.py once each way a step; with --coo_sorted_bwd K5 also takes
the COO lookup's backward) and DeepFM's dense step with --field_blocks
(K8 field_block_scatter); after the DeepFM one, the libsvm zoo (LR,
FNN, IPNN, OPNN, NFM, AFM, DCN, DeepMVM) at its published widths on the
same files, K1/K2 at row widths 33, 257 and 32; then DeepFM under the
other optimizers' lazy row forms (Adagrad, FTRL, Momentum, GD: K1/K2 on
the plain [V+1, 17] store) and Wide&Deep (the canned wdl optimizer, the
dense step, no kernel in training; K1 at its two serving gathers); then
the repo's four single-process presets (criteo_headline: the dense step,
no kernel; criteo_singlepass: K1/K2; esmm_large_vocab: K1-K4 on the bf16
fused store and the slim wire; din_large_vocab: K1, K2, K5, K6 on the
bf16 fused store).
Phases, each fatal on failure (exit code 1, no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build of every CUDA kernel from tf_repos_tpu_torch/ops/csrc (one
     nvcc per source, started together, sm_90a);
  3. kernel vs plain PyTorch on the card, at each main path's shapes:
     a. DeepFM (B=16384, 26 dynamic fields of Zipf(1.2) ids remapped by
        the host dedup mapper, K=1+16) plus a ragged and an
        all-duplicates case: expand_rows must be bit-exact (f32, and
        bf16 at the same row stride);
        accumulate_rows (atomics, run-to-run sum order) must satisfy
        |kernel - plain| <= 1e-4 * sum_i |g_i| per element: f32
        round-off grows like sqrt(n) * 6e-8 <= 4e-5 of that sum for the
        hottest row of 425,984 slots; and at the edges of its
        sort-and-reduce (one tile on one id; N = T-1, T, T+1 at K = 5,
        16, 17, 48; +-0 rows and a NaN row, which must come out NaN as
        with index_add_); and K1 and K2 at the same ids on the unfused
        store of the other optimizers' lazy rows (the rows a contiguous
        [S, 17] block, stride 17), held and timed as in f;
     b. ESMM at the published Ali-CCP point (4.5M vocab, B=4096, K=16,
        pad 512, published multi-hot lengths, Zipf(1.2) ids, the port's
        packer with combine and its mapper) plus a shuffled-triplet, a
        pad-heavy and (K3) a bf16-table case: coo_pool_rows and
        coo_accumulate_rows must satisfy |kernel - plain| <=
        1e-4 * sum_i |w_i x_i| + 1e-6 per element, for the same reason,
        and coo_accumulate_rows at its tile's edges as accumulate_rows;
        beside the coo_pool_rows time, the reductions it sends to device
        memory and the longest chain on one address, under the first
        design's flat walk and this strip walk (pool_reductions), its
        time on an all-zero table, where it sends none, and the time of
        the wrapper's zero fill alone;
        expand_rows (bit-exact, f32 and bf16) and accumulate_rows at the
        same S on the single-valued fields' ids, the table being the w
        columns of the [S, 48] store, and expand_rows also on its m
        columns (su[:, 16:32], 16-byte aligned) and on su[:, 1:17];
     c. DIN at the same published point, batches through the port's
        bucketer, packer (compact segment and idx-sorted streams) and
        mapper: sorted_segsum at n_out = G (the pooled bags) and at
        n_out = Su (the idx-sorted runs, where the TPU ran
        sorted_segsum_packed), in f32 and bf16, plus an all-padding
        stream, each within 1e-4 * sum_i |v_i| + 1e-6 per element of
        its plain version (atomics: run-to-run sum order); beside each
        sorted_segsum time, the reductions it sends to device memory and
        the longest chain on one address, under a scalar design's rule
        (one atomic per run and column) and this one's
        (segsum_reductions), and its time on all-zero values, where it
        sends none;
        sorted_expand bit-exact in both dtypes; K1 (f32 and bf16) and K2 on the COO
        lookup's ids, and K2 on the shared lookup's ids (the step's own
        layout, a cotangent of exactly 0 on the a_int padding slots);
        beside each K2 and K4 time, the longest chain: the most slots on
        one id (host bincount) and the tiles that hold it;
     d. K7 at the ESMM point (the uids of one batch, S=114,688; the
        [4.5M+1, 128] lane-padded store, and again at width 48): bit-exact
        against the masked assignment, timed against index_copy_;
     e. K8 at the DeepFM point (B=16384, 39 fields in 13 one-row and 26
        large blocks, W=17) in bf16 and f32 mode, and with out-of-block
        and -1 ids: within 1e-4 * sum_i |g_i| + 1e-6 per element (atomics:
        run-to-run sum order), timed against index_add_, with the
        reductions it sends to device memory and the flush chain on the
        one-row fields (field_block_reductions), and its time with every
        id -1, where it adds nothing;
     f. K1 and K2 at the zoo's row widths, on one Zipf(1.2) batch of the
        DeepFM point through each model's mapper, all 39 fields through
        the lookup: width 33 (IPNN, B=16384, row stride 99), 257 (NFM at
        B=16384 and AFM at its B=4096, stride 771) and 32 (DCN, stride
        96): K1 bit-exact (f32 and bf16), K2 within 1e-4 * sum_i |g_i| +
        1e-6, each timed against its plain version and index_select /
        index_add;
     g. stochastic rounding (ops/rounding.py) on the card bit-identical
        to the CPU for the same noise on 1M random bit patterns and the
        edge values (infinities, NaNs, the all-ones NaN, the largest
        finite, +-0, subnormals), and rounding up 0.25 ulp above 1.0 at
        a rate of 0.25 +- 0.01 over 200,000 draws from a generator on the
        card; then K1 and K2 on the f32 rows the step gathers from the
        fused [4,500,001, 48] bf16 store at the esmm_large_vocab point
        (S = 114,688), as in f, beside the row gather from bf16 and f32;
  4. the main paths: ``tf_repos_tpu_torch.main`` --task_type=train at
     full width on the native host input (C++ parsers and duplicate
     combine, data/native.py), DeepFM for >= 20 steps on synthetic Zipf
     libsvm data (the blob parser on its thread pool), ESMM (the whole
     cell esmm_coo_dma_combine: K7 once a step) for >= 10 steps on
     Ali-CCP lines from the port's writer with --map_workers=2
     --packed_cache=true, three times: the run that parses and writes
     the cache, a second that must only read it (sidecars present, none
     rewritten), and --map_workers=1 on the cache, whose eval and last
     train loss must match the second run's within 1e-4 relative; DIN
     for >= 10 steps on the same lines, then DIN --task_type=eval, then
     DIN with --coo_sorted_bwd --map_workers=2 (K5 three times a step),
     whose eval and last train loss must match the same leg's with
     --map_workers=1 within 1e-4 relative, then DeepFM's dense step
     with --field_blocks for >= 20 steps on per-field-block libsvm data
     (K8 once a step); each kernel of the path must have launched; each
     run's CLI examples/s from the creation of its training input to
     its last ``INFO: step`` line (StepClock), and the examples/s of
     that input alone (host_rate); before them, the host input's stages
     on this host, one batch each (DeepFM: the Python and the native libsvm
     parse of 16,384 lines, which must agree; ESMM: the Python and the
     native Ali-CCP parse of 4,096 lines, bit-equal, the packer with the
     np.unique and the native combine, equal streams, and the mapper)
     and the pad --multi_hot_pad=0 would pick for the ESMM lines; then
     each bare step timed on pre-mapped batches (DeepFM sparse, with
     catch-up, dense, dense with --field_blocks; ESMM; DIN, with
     --coo_sorted_bwd, with --dma_scatter), and each CLI leg's examples/s
     beside its bare step's; the zoo, after the DeepFM path and on its
     files (one epoch each), at the published configurations of
     scripts/zoo_auc.py (deep_ctr/run.sh), bf16 towers, dropout on: FNN,
     IPNN, OPNN, DCN, DeepMVM at K=32, NFM and AFM at K=256, all on
     --sparse_table_update --fused_table --pallas_expand, LR on
     --sparse_table_update alone; B=16384 but OPNN at 2048 (its
     [B, 760032] deep input) and AFM at 4096 (its [B, 741, 256] pairs),
     printed as cuts; each trained then evaluated, finite loss and AUC in
     [0, 1], K1 and K2 once a step (LR: neither), its peak device memory,
     CLI examples/s and bare step (10 steps on pre-mapped batches); LR
     again on the CPU, its eval and last train loss within 1e-4 relative
     of the card's; DeepFM at the main path's width and files under each
     of --optimizer=Adagrad, ftrl, Momentum and GD with
     --sparse_table_update --pallas_expand and no fused store (21 steps,
     K1 and K2 once a step, then its eval) and each one's bare step;
     Wide&Deep at its published configuration (scripts/zoo_auc.py:62-64:
     wdl, K=32, towers 256/128/64, no dropout; bf16 towers, B=16,384,
     printed beside the published 128) on CSV lines from the port's writer
     (ids over all 10,000 buckets of each column, so all 260,000 rows of
     its tables are reachable): 20 steps on the streaming reader, 20
     with --packed_cache=true building the cache and 20 on it (no sidecar
     rewritten; the two runs' eval and last train loss within 1e-4
     relative), "wide" for 10 steps, each evaluated, no K1/K2 launch in
     training; the Python parse of one batch, each run's CLI examples/s
     and peak device memory, the input alone, and the bare dense step;
     the presets criteo_headline, criteo_singlepass (on the DeepFM files),
     esmm_large_vocab and din_large_vocab (on the ESMM lines, 4.5M vocab,
     K=16, B=4096) through the CLI with --preset=<name> and the model
     widths (the Ali-CCP ones with --steps_per_dispatch=5, a plain loop
     either way, to log within their 10 steps): train (each kernel of the
     preset's step launched as often as it runs a step, the others not
     at all), eval (the train run's final eval within 1e-4 relative),
     export; the bf16 runs' servables scored on 64 va lines by the card's
     and a CPU scorer within 2e-2; each preset's CLI examples/s and peak
     device memory, its first batches with and without --slim_transfer
     (wire bytes per example, the host encode of one batch, the decoded
     slim batches equal to the full ones on the card), its tables and
     state in bytes against f32, its bare step (10 steps on 4 batches);
     criteo_singlepass and esmm_large_vocab 3 steps on each wire from one
     init, losses within 1e-6 relative; K3 and K4 on the COO stream the
     card decoded from the esmm_large_vocab wire, and K5 and K6 on DIN's
     compact stream rebuilt on the card from the wire's counts (equal to
     the packer's), each against its plain version;
  6. the mesh (tf_repos_tpu_torch/parallel/, mesh_phase, after the
     --field_blocks path): (a) DeepFM at the bench point on a 2x2 mesh,
     four gloo ranks on the one card, the main path's 21 steps through
     the harness, each step's loss within 2e-4 relative (+ 2e-5) of the
     single-device run from the same init and batches (the JAX package's
     sharded-vs-single bar), K1 and K2 once a step on every rank; (c) its
     checkpoint evaluated on one device, loss and AUC held to the mesh's
     own final eval likewise; (b) ESMM at the published point on a 1x2
     mesh (--map_workers=2 on the ESMM path's cache), its logged losses
     held to the single-device "cache hit" run's likewise, K2, K4 and K7
     once a step and K1, K3 on every rank, and one more step checked on
     rank 0's store shard: every row outside the step's uids bit-
     unchanged, the lanes past 3K and the spare row 0; each leg's bare
     step a rank, its collectives' time (each one synchronised and
     timed) and share, beside the backend; (d) a one-rank NCCL group
     running the sharded lazy step at 1x1 against the single-device step
     for 3 steps (losses within 1e-6 relative, the w|m|v store within
     1e-4: K2's atomics sum in another order on each run), the state's
     shard/assemble round trip bit-exact on the card, and an NCCL
     all-reduce and broadcast (the 1x1 step itself calls none); (e) --profile_steps=2 on the single-device
     DeepFM CLI (the trace names expand_rows_kernel and
     accumulate_rows_kernel) and --check_numerics on a poisoned run (exit
     nonzero with FloatingPointError); then K1/K2 at the 2x2 rank's shapes
     (as in f) and K7 on the 1x2 rank's store shard (bit-exact, timed
     against index_copy_);
  7. several hosts (--dist_mode=2; multihost_phase, after phase 6): two
     host processes on 127.0.0.1 (free ports) whose ranks share the one
     card over gloo, each through the launcher's host entry
     (parallel/launch.run_on_hosts) with an explicit device list: (a)
     DeepFM at the bench width with the multihost preset's flags, 2x2
     over two hosts, 16 steps on each host's 16-batch file (slices of
     the main path's lines), both hosts' loss lines equal, the logged
     losses held to the single-device step on the same global batches
     (phase 6's bar) and the store within 1e-4, K1 and K2 once a step
     on all 4 ranks; (b) ESMM --mh_coo --dma_scatter at the published
     point, 2x1 over two hosts, 8 steps, held likewise, K2, K4, K7 once
     and K3 at least once a step on each rank, each host's own COO
     bucket beside the cross-host one; (c) (a)'s checkpoint inferred on
     two hosts over te files of 3 batches and 5,000 lines (the template
     path), held to the one-process pred.txt (rtol 1e-5, one unit of its
     sixth decimal); (d) --slim_transfer on a one-host 2x2 mesh, 5
     steps, held to the unwired mesh run (losses as (a), store 1e-4);
     (e) the port's Criteo surrogate (300,000 train lines from worker
     processes, 50,000 test lines, the Bayes ceiling), its preprocessor,
     then DeepFM's dense step one epoch on --field_blocks=auto:<feature_map>
     (K8 once a step), eval AUC and exact_auc over SURR_AUC_BAR beside
     the ceiling; then K1/K2 at a two-host rank's shapes, K3/K4 on one
     host's COO re-padded to the cross-host bucket and K7 with the global
     uids (consensus_point), and K8 on the surrogate's blocks;
  5. 5-step trajectories with f32 towers on the card (kernels) against
     the same steps on the CPU (plain versions), same weights and
     batches: DeepFM at B=1024, ESMM --dma_scatter and DIN (both DIN
     legs) at B=512 (vocab 50k, pad 64); loss within 1e-4 relative,
     w|m|v rows and dense weights within 1e-4 absolute (f32 sums in
     another order on the card; 1e-4 is a fifth of one Adam step at lr
     5e-4); DeepFM dense --field_blocks at B=1024: loss within 1e-4
     relative, and every weight within 1e-4 once the CPU's steps take
     the card's ReLU gates (field_block_trajectory says why); the seven
     kernel models of the zoo at B=1024, vocab 50k, held as DeepFM's;
     DeepFM under each of the four other lazy optimizers at B=1024 (every
     row store held), and Wide&Deep's dense wdl step at B=1024 (loss 1e-4
     relative; weights 1e-4, with the card's ReLU gates replayed on the
     CPU if any of the CPU's own differs); on bf16 stores with the noise
     replayed (a CPU generator of one seed drawn through the noise seam
     in both runs) and the card's ReLU gates: ESMM on the fused store with
     catch-up at B=512 and DeepFM --fused_moments under Adam and FTRL at
     B=1,024, 5 steps held as above (loss 1e-4, f32 stores and dense
     weights 1e-4; the bf16 stores' elements apart printed), and each
     row update of those 5 steps again on the CPU from the card's inputs
     (store, rows, ids, row gradients, noise): every bf16 store equal but
     for elements one ulp apart, the others equal;
  4b. serving, from the main paths' checkpoints: DeepFM at the bench
     width exported and inferred (one te batch) through the CLI, then
     served by PredictionServer(grpc_port=-1, device="cuda"): REST
     requests of 1, 8, 64 and 512 instances, a columnar and a grpc-web
     request and one with ids -1, V and 2**31-1, each equal to
     Scorer.score on the card and within 2e-2 of a CPU scorer (bf16
     towers); pred.txt within 2e-2 of the card scorer; K1 launched at
     least once a scored batch; hot reload; latency per bucket (50
     scorer calls each) and HTTP round trips; ESMM and DIN exported and
     scored (one bucket of 64 va lines) by the card's and a CPU scorer;
     the device operations of one DeepFM bucket-512 Scorer.score
     (torch.profiler); K1 at each scorer's gather over the whole table,
     the ids as the model passes them: the one-launch serving entry
     (JAX's id rule in the kernel) bit-exact in f32 and bf16, wild ids
     included, and exactly one device operation; timed alone, as the
     whole gather before (normalize_ids + K1) and now, beside
     index_select and an empty launch (torch.cuda._sleep(0)); the zoo's
     IPNN and LR exported and scored (one bucket of 64 va lines) by the
     card's and a CPU scorer within 2e-2, one K1 launch each (LR's [V]
     table gathered as its [V, 1] view, timed as the serving gathers
     above); Wide&Deep exported and inferred (2,048 te lines) through the
     CLI, one bucket of 64 va lines scored by the card's and a CPU scorer
     within 2e-2 with K1 launched twice (emb, and wide_cat's [V, 1] view),
     one REST request of cont/cat instances through PredictionServer on
     the card equal to Scorer.score, and both gathers checked and timed
     as the serving gathers above;
  8. after serving, the port's serving load benchmarks and zoo AUC
     ladder through their scripts (serving_load_phase): (a)
     scripts/torch_bench_serving.py --repeats=10 (its own DeepFM servable
     at V=117,581, K=16, towers 256/128/64; HTTP batches of 1 to 256
     instances, one client): each batch size's K1 launches equal to the
     micro-batches scored and to the requests, each batch's predictions
     within 1e-5 relative of a CPU Scorer (f32 towers), the fit and the
     /stats split logged;
     (b) scripts/torch_bench_serving_load.py on (a)'s servable, rest and
     example at 1, 8 and 32 clients for 2 s: no error or shed, occupancy
     at least 1, K1 once a scored micro-batch (between the level's
     instances over max_batch and its requests); (c)
     scripts/torch_zoo_auc.py, DeepFM and LR (wide on the csv view), one
     epoch on phase 7e's surrogate files, its csv view made in 7e's
     process and its ceiling (nothing generated again): no row error,
     each AUC in [LADDER_AUC_BAR, ceiling + 0.01]; each row's checkpoint
     inferred on the card (K1 once a batch: one table gather) and on the
     CPU, pred.txt within 2e-5 relative (+ one unit of its sixth
     decimal). K1 gets three rows of its own in the kernel report, each
     timed at its own table and ids: the bench servable (launches of (a)
     and (b)) and each ladder row's infer;
then one "phase N: <s> s" line a phase, the kernel report line (with
the mesh ranks' K1, K2 and K7 rows, phase 7's K1, K2, K3, K4, K7 and K8
rows and phase 8's K1 rows) and, last, the device line. A rank of phase 6 or 7 is a
spawned process, and a phase-7 host a process of its own: both import
this script (hence the __main__ guard) and the harness.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from tf_repos_tpu_torch import main as cli  # noqa: E402
from tf_repos_tpu_torch.config import Config, parse_config  # noqa: E402
from tf_repos_tpu_torch.data import native  # noqa: E402
from tf_repos_tpu_torch.data.csv import parse_csv_lines  # noqa: E402
from tf_repos_tpu_torch.data.libsvm import LibsvmDataset, parse_libsvm_lines  # noqa: E402
from tf_repos_tpu_torch.data.ragged import (  # noqa: E402
    MH_PAIRS,
    auto_multi_hot_pad,
    parse_aliccp_lines,
)
from tf_repos_tpu_torch.data.sparse_batch import (  # noqa: E402
    MHC_CDEST,
    MHC_CIDX,
    MHC_CNT,
    MHC_DEST,
    MHC_IDX,
    MHC_PERM,
    MHC_SROWS,
    MHC_W,
    UIDS_PREFIX,
    MhCooPacker,
    MhPadBucketer,
    SparseBatchMapper,
)
from tf_repos_tpu_torch.data.synthetic import (  # noqa: E402
    PUBLISHED_MH_AVG_LENS,
    synthetic_aliccp_batch,
    synthetic_criteo_batch,
    write_synthetic_aliccp,
    write_synthetic_libsvm,
)
from tf_repos_tpu_torch.models import create_model  # noqa: E402
from tf_repos_tpu_torch.ops import att_unit as AU  # noqa: E402
from tf_repos_tpu_torch.ops import build  # noqa: E402
from tf_repos_tpu_torch.ops import coo_pool as CP  # noqa: E402
from tf_repos_tpu_torch.ops import field_block as FB  # noqa: E402
from tf_repos_tpu_torch.ops import rounding as RD  # noqa: E402
from tf_repos_tpu_torch.ops import row_scatter as RS  # noqa: E402
from tf_repos_tpu_torch.ops import sorted_seg as SG  # noqa: E402
from tf_repos_tpu_torch.ops import sparse_rows as SR  # noqa: E402
from tf_repos_tpu_torch.ops import towers as T  # noqa: E402
from tf_repos_tpu_torch.serve import predict_proto as PP  # noqa: E402
from tf_repos_tpu_torch.serve.scorer import Scorer  # noqa: E402
from tf_repos_tpu_torch.serve.server import PredictionServer  # noqa: E402
from tf_repos_tpu_torch.train import loop as L  # noqa: E402
from tf_repos_tpu_torch.train import sparse as SP  # noqa: E402
from tf_repos_tpu_torch.train.harness import Harness, to_device  # noqa: E402
from tf_repos_tpu_torch.train.optimizers import make_optimizer  # noqa: E402
from tf_repos_tpu_torch.train.step_graph import GraphedStep  # noqa: E402
from tf_repos_tpu_torch.utils.platform import card_label  # noqa: E402
from tf_repos_tpu_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores

# the main path's configuration: the repo's DeepFM benchmark point
WIDTH = dict(
    model="DeepFM", feature_size=117_581, field_size=39, embedding_size=16,
    deep_layers="256,128,64", dropout="1.0,1.0,1.0", batch_size=16384,
    learning_rate=0.0005, l2_reg=0.0001, optimizer="Adam", static_fields=13,
    compute_dtype="bfloat16", sparse_table_update=True, fused_table=True,
    pallas_expand=True,
)
B = WIDTH["batch_size"]
STATIC = WIDTH["static_fields"]
MAIN_STEPS = 21

# the ESMM main path: the JAX package's published Ali-CCP point
# (scripts/bench_published.py, cell esmm_coo_dma_combine), at full width
ESMM_WIDTH = dict(
    model="ESMM", feature_size=4_500_000, field_size=11, embedding_size=16,
    deep_layers="256,128", dropout="1.0,1.0", batch_size=4096,
    learning_rate=0.0005, l2_reg=0.0001, optimizer="Adam", multi_hot_pad=512,
    compute_dtype="bfloat16", param_dtype="float32", sparse_table_update=True,
    fused_table=True, pallas_expand=True, mh_coo=True, mh_coo_combine=True,
    dma_scatter=True,
)
EB = ESMM_WIDTH["batch_size"]
ESMM_STEPS = 10
MH_FIELDS = ("u_catids", "u_shopids", "u_brandids", "u_intids", "a_intids")

# the DIN main path: the JAX package's published DIN point
# (scripts/bench_published.py, cell din_att_coo_fused_table), at full
# width; it trains on the ESMM path's Ali-CCP lines (same generator)
DIN_WIDTH = dict(
    model="DIN", feature_size=4_500_000, field_size=11, embedding_size=16,
    deep_layers="256,128", attention_layers="256", dropout="1.0,1.0", batch_size=4096,
    learning_rate=0.0005, l2_reg=0.0001, optimizer="Adam", multi_hot_pad=512,
    compute_dtype="bfloat16", param_dtype="float32", attention_pooling=True,
    sparse_table_update=True, fused_table=True, pallas_expand=True, mh_coo=True,
    mh_bucket="pow2",
)

# the DeepFM dense step with --field_blocks at the benchmark width: the
# synthetic writer's per-field blocks (zipf_a=0: ids 1..13 for the
# continuous fields, then 26 equal blocks; data/synthetic.py), the
# table gradient on K8
FB_BLOCK = (WIDTH["feature_size"] - 14) // 26
FB_OFFSETS = tuple(range(1, 14)) + tuple(14 + j * FB_BLOCK for j in range(26))
FB_SIZES = (1,) * 13 + (FB_BLOCK,) * 26
FB_WIDTH = dict(WIDTH, sparse_table_update=False, fused_table=False, pallas_expand=False,
                field_blocks=",".join(f"{o}:{s}" for o, s in zip(FB_OFFSETS, FB_SIZES)))
FB_STEPS = 20

# the libsvm zoo, trained on the DeepFM main path's files: each model at
# its published configuration (scripts/zoo_auc.py:43-81, the reference's
# deep_ctr/run.sh; LR on run.sh's Adam, lr 5e-4, l2 1e-4), bf16 towers,
# the lazy-sparse step on the fused w|m|v store with K1/K2 as its lookup;
# LR on plain lazy Adam (its 1-D table has neither a fused store nor rows
# for the kernels)
ZOO_KERNELS = dict(sparse_table_update=True, fused_table=True, pallas_expand=True)
ZOO_PNN = dict(learning_rate=1e-4, embedding_size=32, deep_layers="256,128", dropout="0.8,0.8",
               l2_reg=1e-4, **ZOO_KERNELS)
ZOO = {
    "LR": dict(model="LR", learning_rate=5e-4, l2_reg=1e-4, sparse_table_update=True),
    "FNN": dict(ZOO_PNN, model="fnn"),
    "IPNN": dict(ZOO_PNN, model="ipnn"),
    # cut: the deep input is [B, 741*32*32 + 39*32] = [B, 760,032], 49.7 GB
    # a copy in f32 at B=16,384; 6.2 GB at 2,048
    "OPNN": dict(ZOO_PNN, model="opnn", batch_size=2048),
    "NFM": dict(model="NFM", learning_rate=5e-5, embedding_size=256, deep_layers="256,128",
                dropout="0.5,0.5,0.5", l2_reg=1e-3, batch_norm=True, **ZOO_KERNELS),
    # cut: the [B, 741, 256] pairs take 12.4 GB a copy in f32 at B=16,384
    "AFM": dict(model="AFM", learning_rate=5e-4, embedding_size=256, attention_layers="128",
                dropout="0.5,0.5", l2_reg=1e-3, batch_size=4096, **ZOO_KERNELS),
    "DCN": dict(model="DCN", learning_rate=1e-4, embedding_size=32, deep_layers="512,256",
                cross_layers=3, dropout="0.8,0.8", l2_reg=1e-5, **ZOO_KERNELS),
    "DeepMVM": dict(ZOO_PNN, model="DeepMVM"),
}
# the kernel report's zoo entries: the model whose lookup phase 3f times,
# and the models whose CLI launches the entry counts
ZOO_POINTS = {"width 33": ("IPNN", ("FNN", "IPNN", "OPNN")), "width 257, NFM": ("NFM", ("NFM",)),
              "width 257, AFM": ("AFM", ("AFM",)), "width 32": ("DCN", ("DCN", "DeepMVM"))}
ZOO_TRAJ_B = 1024  # the card-vs-CPU trajectories' batch

# the other optimizers' lazy row forms on the DeepFM main path's width and
# files: no fused store (it is Adam's), so K1 and K2 read and write a
# plain [S, 17] block gathered from the [V+1, 17] table store (stride 17)
LAZY_OPTS = ("Adagrad", "ftrl", "Momentum", "GD")
LAZY_WIDTH = dict(WIDTH, fused_table=False)

# Wide&Deep at its published configuration (scripts/zoo_auc.py:62-64, the
# reference's wide_n_deep run: the canned wdl optimizer, K=32, towers
# 256/128/64, no dropout) on Criteo CSV lines, bf16 towers, at the bench
# batch (published 128); "wide" (:53-55) likewise. Every one of the
# 26 * 10,000 table rows is reachable: the writer draws ids from all 10,000
# buckets of a column
WD_WIDTH = dict(model="wide_n_deep", optimizer="wdl", embedding_size=32,
                deep_layers="256,128,64", dropout="1.0,1.0,1.0", batch_size=B,
                compute_dtype="bfloat16", feature_size=0, field_size=39)
WD_FILES = 4  # tr.part<i>.csv, written in parallel
WD_TR_ROWS = 10 * B  # one epoch = 10 steps; the runs take 2 epochs
WD_BUCKETS = 10_000


def zoo_width(name: str) -> dict:
    return dict(dict(feature_size=WIDTH["feature_size"], field_size=WIDTH["field_size"],
                     optimizer="Adam", compute_dtype="bfloat16", batch_size=B), **ZOO[name])


def log(msg: str) -> None:
    print(msg, flush=True)


def script(name: str):
    """The port's script scripts/<name>.py as a module (scripts/ is no
    package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PHASE_S: dict = {}  # seconds spent in each phase, printed at the end


def timed(phase: str, fn, *args):
    """fn(*args), its wall time added to PHASE_S[phase]."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_S[phase] = PHASE_S.get(phase, 0.0) + time.perf_counter() - t0


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def cuda_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device time of one call, from CUDA events around ``iters`` calls.
    A busy-wait kernel queued first lets the host enqueue all the calls
    before the first one runs, so the events time the kernels back to
    back and not the host's per-call Python cost (which is larger than a
    15 us kernel)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # ~20 ms of GPU clock cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class StepClock:
    """Tees stdout during a CLI training run from step 0 and stamps each
    ``INFO: step = N`` line with the host clock, and the moment the
    harness creates its training input (``Harness._dataset("tr")``). The
    run's examples/s: the steps of the last such line, times the batch,
    over the time from the input's creation to that line, so that the
    batches made before the first step are paid for (as in host_rate);
    the model's set-up before it is left out."""

    def __init__(self):
        self.stamps = []
        self.t0 = None

    def __enter__(self):
        self._out, sys.stdout = sys.stdout, self
        self._dataset = Harness._dataset
        clock = self

        def stamped(h, split, **kw):
            if split == "tr" and clock.t0 is None:
                clock.t0 = time.perf_counter()
            return clock._dataset(h, split, **kw)

        Harness._dataset = stamped
        return self

    def __exit__(self, *exc):
        sys.stdout = self._out
        Harness._dataset = self._dataset

    def write(self, s):
        if s.startswith("INFO: step = "):
            self.stamps.append((time.perf_counter(), int(s.split()[3].rstrip(","))))
        return self._out.write(s)

    def flush(self):
        self._out.flush()

    def ex_per_s(self, batch: int) -> float:
        check(self.t0 is not None and len(self.stamps) >= 1,
              f"no training input or no INFO: step line: {self.t0}, {self.stamps}")
        t1, s1 = self.stamps[-1]
        return s1 * batch / (t1 - self.t0)


def host_rate(argv, batch: int) -> float:
    """Examples/s of a CLI run's training input alone: the harness's
    reader, map chain and prefetch thread for the argv's flags, iterated
    for one epoch with no step, from the iterator's creation to its last
    batch."""
    h = Harness(parse_config(argv))
    t0 = time.perf_counter()
    n = sum(1 for _ in h._dataset("tr", shuffle=True, epochs=1))
    return n * batch / (time.perf_counter() - t0)


def best_s(fn, n: int = 3):
    """(seconds of the fastest of n calls, the last call's result)."""
    best, out = float("inf"), None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


def longest_chain(idx: torch.Tensor, tile: int, live=None):
    """(slots, tiles): the most slots on one id, from a host bincount of
    idx (the chain of atomics on that row's address when each slot adds
    its own), and the tiles of ``tile`` slots that hold that id (the most
    atomics a column the sort-and-reduce of K2/K4 issues on it). live:
    an optional mask of the slots that count."""
    i = idx.cpu().numpy()
    pos = np.nonzero(live.cpu().numpy())[0] if live is not None else np.arange(i.size)
    counts = np.bincount(i[pos])
    hot = int(counts.argmax())
    return int(counts[hot]), int(np.unique(pos[i[pos] == hot] // tile).size)


def zipf_batches(n: int, seed: int = 0, batch: int = B, vocab: int = WIDTH["feature_size"]):
    """The benchmark's id distribution: Criteo-shaped batches whose ids are
    redrawn as Zipf(1.2) ranks, the 13 static fields kept at ids 1..13."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = synthetic_criteo_batch(rng, batch, vocab)
        z = np.minimum(rng.zipf(1.2, size=b["feat_ids"].shape), vocab - 1)
        b["feat_ids"] = np.where(b["feat_ids"] > 0, z.astype(np.int32), 0)
        b["feat_ids"][:, :STATIC] = np.arange(1, STATIC + 1)
        out.append(b)
    return out


# ------------------------------------------------------------------ phase 3
def deepfm_point(dev):
    """One DeepFM batch at the benchmark point (B=16384, Zipf(1.2) ids)
    through the host dedup mapper, and K1's and K2's inputs on the card:
    the 26 dynamic fields' remapped ids, S, and the gathered [S, 3K]
    w|m|v rows ``su``, whose w columns are the table (a [S, K] view with
    row stride 3K, as on the main path)."""
    model = create_model(Config(**WIDTH))
    mapped = SparseBatchMapper(model.sparse_slots())(zipf_batches(1)[0])
    s = int(mapped["__uids_fm_wv"].shape[0])
    idx = torch.from_numpy(np.ascontiguousarray(mapped["feat_ids"][:, STATIC:]).reshape(-1)).to(dev)
    k = 1 + WIDTH["embedding_size"]
    gen = torch.Generator(device=dev).manual_seed(0)
    su = torch.randn((s, 3 * k), generator=gen, device=dev)
    return dict(mapped=mapped, s=s, idx=idx, n=idx.shape[0], k=k, gen=gen, su=su, table=su[:, :k])


def k1_exact(label, store, lo, k, idx):
    """K1 bit-exact against table[idx] on the view store[:, lo:lo+k], in
    the store's f32 and in bf16 (the same view of a bf16 copy)."""
    for st in (store, store.to(torch.bfloat16)):
        t = st[:, lo:lo + k]
        check(torch.equal(SR.expand_rows(t, idx), SR.expand_rows_plain(t, idx)),
              f"expand_rows {label} ({t.dtype}, row stride {t.stride(0)}, column {lo}) differs "
              "from table[idx]")


def kernel_phase(dev):
    pt = deepfm_point(dev)
    mapped, s, idx, n, k, gen, table = (pt[key] for key in ("mapped", "s", "idx", "n", "k", "gen",
                                                            "table"))
    g = torch.randn((n, k), generator=gen, device=dev)
    log(f"kernel shapes: S={s} N={n} K={k} (unique rows {int((mapped['__uids_fm_wv'] < WIDTH['feature_size']).sum())})")

    # K1
    out_k = SR.expand_rows(table, idx)
    torch.cuda.synchronize()
    err1 = float((out_k - SR.expand_rows_plain(table, idx)).abs().max())
    k1_exact("at the DeepFM point", pt["su"], 0, k, idx)
    # K2
    acc_k = SR.accumulate_rows(g, idx, s)
    acc_p = SR.accumulate_rows_plain(g, idx, s)
    scale = SR.accumulate_rows_plain(g.abs(), idx, s)
    diff = (acc_k - acc_p).abs()
    err2 = float(diff.max())
    check(bool((diff <= 1e-4 * scale + 1e-6).all()), f"accumulate_rows differs: max abs err {err2}")
    tile = SR._lib().tr_accumulate_rows_tile()
    accumulate_edges(dev, gen, tile)

    # ragged N, all duplicates, bf16
    for name, n2, s2, dup in (("ragged", 1_000_003, 777, False), ("all-duplicates", 100_000, 64, True)):
        i2 = (torch.full((n2,), 5, dtype=torch.int32, device=dev) if dup else
              torch.randint(0, s2, (n2,), generator=gen, device=dev, dtype=torch.int32))
        t2 = torch.randn((s2, k), generator=gen, device=dev)
        g2 = torch.randn((n2, k), generator=gen, device=dev)
        check(torch.equal(SR.expand_rows(t2, i2), t2[i2]), f"expand_rows {name}")
        d2 = (SR.accumulate_rows(g2, i2, s2) - SR.accumulate_rows_plain(g2, i2, s2)).abs()
        sc2 = SR.accumulate_rows_plain(g2.abs(), i2, s2)
        check(bool((d2 <= 1e-4 * sc2 + 1e-6).all()), f"accumulate_rows {name}: {float(d2.max())}")
        log(f"kernel check {name}: N={n2} S={s2} ok (accumulate max abs err {float(d2.max()):.3e})")
    tb = table.to(torch.bfloat16)
    check(torch.equal(SR.expand_rows(tb, idx), tb[idx]), "expand_rows bf16")
    gb = g.to(torch.bfloat16)
    db = (SR.accumulate_rows(gb, idx, s) - SR.accumulate_rows_plain(gb, idx, s)).abs()
    check(bool((db <= 1e-4 * scale + 1e-6).all()), "accumulate_rows bf16 cotangent")
    log("kernel check bf16 table / bf16 cotangent: ok")

    # times at the main path's shapes
    zeros = torch.zeros((s, k), device=dev)
    t = {
        "expand_rows": (cuda_ms(lambda: SR.expand_rows(table, idx)),
                        cuda_ms(lambda: SR.expand_rows_plain(table, idx)),
                        cuda_ms(lambda: torch.index_select(table, 0, idx))),
        "accumulate_rows": (cuda_ms(lambda: SR.accumulate_rows(g, idx, s)),
                            cuda_ms(lambda: SR.accumulate_rows_plain(g, idx, s)),
                            cuda_ms(lambda: torch.index_add(zeros, 0, idx, g))),
    }
    # least time: each input read once, each output written once
    bytes1 = n * 4 + s * k * 4 + n * k * 4
    bytes2 = n * k * 4 + n * 4 + s * k * 4
    bound = {
        "expand_rows": bytes1 / HBM_BYTES_PER_S * 1e3,  # a copy: no arithmetic
        "accumulate_rows": max(bytes2 / HBM_BYTES_PER_S, n * k / F32_FLOPS) * 1e3,
    }
    err = {"expand_rows": err1, "accumulate_rows": err2}
    for name in t:
        ms, plain, lib = t[name]
        log(f"kernel {name}: max_abs_err {err[name]:.3e}  {ms:.4f} ms  plain {plain:.4f} ms  "
            f"library {lib:.4f} ms  bound {bound[name]:.4f} ms (bytes)")
    slots, tiles = longest_chain(idx, tile)
    log(f"kernel accumulate_rows at the DeepFM point: longest chain {slots} slots on one id "
        f"(the most atomics a column on one address with one per slot); {tiles} of "
        f"{-(-n // tile)} tiles of {tile} slots hold it")
    return {"t": t, "bound": bound, "bound_by": "bytes", "err": err}


def accumulate_edges(dev, gen, tile):
    """K2 at the edges of its sort-and-reduce: one tile whose every slot
    is one id; N = T - 1, T, T + 1 at K = 5, 16, 17, 48 (scalar and
    vector paths); a cotangent with +-0 rows and one NaN row, whose row
    must come out NaN as with index_add_."""
    def acc(name, g2, i2, s2):
        got, want = SR.accumulate_rows(g2, i2, s2), SR.accumulate_rows_plain(g2, i2, s2)
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        check(torch.equal(torch.isnan(got), nan), f"accumulate_rows {name}: NaN rows differ")
        d = (got - want).abs()[~nan]
        sc = SR.accumulate_rows_plain(g2.abs(), i2, s2)[~nan]
        check(bool((d <= 1e-4 * sc + 1e-6).all()), f"accumulate_rows {name}: {float(d.max())}")
        return float(d.max())

    ones = SR.accumulate_rows(torch.ones((tile, 16), device=dev),
                              torch.full((tile,), 7, dtype=torch.int32, device=dev), 64)
    check(bool((ones[7] == tile).all()) and float(ones.sum()) == tile * 16,
          "accumulate_rows: one tile on one id")
    worst = 0.0
    for n2 in (tile - 1, tile, tile + 1):
        for k2 in (5, 16, 17, 48):
            i2 = torch.randint(0, 300, (n2,), generator=gen, device=dev, dtype=torch.int32)
            worst = max(worst, acc(f"N={n2} K={k2}", torch.randn((n2, k2), generator=gen, device=dev),
                                   i2, 300))
    g2 = torch.randn((4 * tile, 16), generator=gen, device=dev)
    g2[100:600], g2[600:1100], g2[3] = 0.0, -0.0, float("nan")
    i2 = torch.randint(0, 500, (4 * tile,), generator=gen, device=dev, dtype=torch.int32)
    e_nan = acc("+-0 and NaN rows", g2, i2, 500)
    log(f"kernel check accumulate_rows edges (T={tile}): one tile on one id exact; N = T-1, T, "
        f"T+1 at K = 5, 16, 17, 48 ok (max abs err {worst:.3e}); +-0 rows and a NaN row ok "
        f"(NaN row out as NaN, others {e_nan:.3e})")


def esmm_batches(n, seed=0, batch=EB, vocab=ESMM_WIDTH["feature_size"],
                 pad=ESMM_WIDTH["multi_hot_pad"]):
    """Padded Ali-CCP batches at the published length point: published
    multi-hot lengths (PUBLISHED_MH_AVG_LENS), Zipf(1.2) ids."""
    rng = np.random.default_rng(seed)
    return [synthetic_aliccp_batch(rng, batch, vocab, multi_hot_pad=pad,
                                   avg_lens=PUBLISHED_MH_AVG_LENS, zipf_a=1.2)
            for _ in range(n)]


def esmm_chain(model):
    """The CLI's host chain for --mh_coo training batches: the COO packer
    (with combine) first, then the dedup mapper."""
    packer = MhCooPacker(model.mh_coo_groups(), combine=True)
    mapper = SparseBatchMapper(model.sparse_slots())
    return lambda b: mapper(packer(dict(b)))


def held(name, got, want, scale) -> float:
    """|got - want| <= 1e-4 * scale + 1e-6 per element; returns the max
    abs difference."""
    torch.cuda.synchronize()
    d = (got - want).abs()
    check(bool((d <= 1e-4 * scale + 1e-6).all()), f"{name} differs: max abs err {float(d.max())}")
    return float(d.max())


def esmm_point(dev):
    """One ESMM batch at the published point through the port's host chain
    (packer with combine, mapper), and K3's and K4's inputs on the card:
    the COO triplet, K3's table (the w columns of the gathered [S, 3K]
    w|m|v rows: a [S, K] view with row stride 3K, as on the main path) and
    K4's cotangent dp [G, K]."""
    model = create_model(Config(**ESMM_WIDTH))
    raw = esmm_batches(1)[0]
    mapped = esmm_chain(model)(raw)
    idx, dest, w = (torch.from_numpy(mapped[key].reshape(-1)).to(dev)
                    for key in (MHC_IDX, MHC_DEST, MHC_W))
    s, k = int(mapped["__uids_emb"].shape[0]), ESMM_WIDTH["embedding_size"]
    g = EB * len(model.mh_coo_groups())
    gen = torch.Generator(device=dev).manual_seed(1)
    store = torch.randn((s, 3 * k), generator=gen, device=dev)
    dp = torch.randn((g, k), generator=gen, device=dev)
    # K1's ids at this point: the lookup of the 14 single-valued fields
    ids = torch.from_numpy(np.concatenate(
        [mapped["feat_ids"]] + [mapped[f][:, None] for f in ("a_catids", "a_shopids", "a_brandids")],
        axis=1).reshape(-1)).to(dev)
    return dict(model=model, raw=raw, mapped=mapped, idx=idx, dest=dest, w=w, m=idx.shape[0],
                m_live=int(mapped[MHC_CNT].sum()), s=s, k=k, g=g, gen=gen, store=store,
                table=store[:, :k], dp=dp, ids=ids)


K3_STRIP = 16  # slots one K3 thread sums (csrc/coo_pool.cu STRIP)


def pool_reductions(dest, w, k):
    """What one K3 launch sends to device memory, counted on the host from
    its slots, every sum taken as non-zero. Returns (scalar, chain_scalar,
    vector, chain_vector): the first design's scalar atomics and the most
    of them on one address; this design's reductions (one per run and
    column group of four: a float4 at K % 4 == 0) and the most of them on
    one address. The first design walked each 256-slot tile's products
    j = r * k + c as one flat run, thread t the products t, t + 256, ...;
    a live product (w != 0) whose target dest * k + c differed from the
    thread's last sent the last one's sum as one atomic, and so did the
    thread's last target. This design's run is the live slots of one
    K3_STRIP-slot strip between changes of dest."""
    d = dest.cpu().numpy().astype(np.int64)
    pos = np.flatnonzero(w.cpu().numpy() != 0)
    groups = -(-k // 4)
    # the flat walk: live products in (tile, thread, step) order
    slot, c = np.repeat(pos, k), np.tile(np.arange(k), pos.size)
    j = (slot % 256) * k + c
    thread = slot // 256 * 256 + j % 256
    order = np.argsort(thread * k + j // 256, kind="stable")
    thread, tgt = thread[order], (d[slot] * k + c)[order]
    sent = tgt[np.concatenate([[True], (thread[1:] != thread[:-1]) | (tgt[1:] != tgt[:-1])])]
    # this design: runs of live slots within a strip
    dl, strip = d[pos], pos // K3_STRIP
    runs = dl[np.concatenate([[True], (strip[1:] != strip[:-1]) | (dl[1:] != dl[:-1])])]
    return (sent.size, int(np.bincount(sent).max()) if sent.size else 0,
            runs.size * groups, int(np.bincount(runs).max()) if runs.size else 0)


def esmm_kernel_phase(dev):
    pt = esmm_point(dev)
    model, mapped, gen, table, dp = pt["model"], pt["mapped"], pt["gen"], pt["table"], pt["dp"]
    idx, dest, w, m, m_live = pt["idx"], pt["dest"], pt["w"], pt["m"], pt["m_live"]
    s, k, g = pt["s"], pt["k"], pt["g"]
    vocab = ESMM_WIDTH["feature_size"]
    live = int(sum((pt["raw"][f] > 0).sum() for f in MH_FIELDS))
    uniq = int((mapped["__uids_emb"] < vocab).sum())
    log(f"ESMM host shapes: {live} live multi-hot slots before combine, {m_live} after "
        f"(COO bucket M={m}); {uniq} unique ids (uids bucket S={s}); pooled rows G={g}; K={k}")

    def pool_err(name, t, i, d, ww):
        return held(name, CP.coo_pool_rows(t, i, d, ww, g), CP.coo_pool_rows_plain(t, i, d, ww, g),
                    CP.coo_pool_rows_plain(t.abs(), i, d, ww.abs(), g))

    def acc_err(name, i, d, ww):
        return held(name, CP.coo_accumulate_rows(dp, i, d, ww, s),
                    CP.coo_accumulate_rows_plain(dp, i, d, ww, s),
                    CP.coo_accumulate_rows_plain(dp.abs(), i, d, ww.abs(), s))

    err = {"coo_pool_rows": pool_err("coo_pool_rows", table, idx, dest, w),
           "coo_accumulate_rows": acc_err("coo_accumulate_rows", idx, dest, w)}
    perm = torch.randperm(m, generator=torch.Generator().manual_seed(2)).to(dev)
    zpad = torch.zeros(3 * m_live, dtype=torch.int32, device=dev)
    cases = {
        "shuffled triplets": (idx[perm], dest[perm], w[perm]),
        "pad-heavy (75% padding)": (torch.cat([idx[:m_live], zpad]), torch.cat([dest[:m_live], zpad]),
                                    torch.cat([w[:m_live], zpad.float()])),
    }
    for name, (i2, d2, w2) in cases.items():
        e3 = pool_err(f"coo_pool_rows {name}", table, i2, d2, w2)
        e4 = acc_err(f"coo_accumulate_rows {name}", i2, d2, w2)
        log(f"kernel check {name}: M={i2.shape[0]} ok (max abs err pool {e3:.3e}, accumulate {e4:.3e})")
    e3 = pool_err("coo_pool_rows bf16 table", table.to(torch.bfloat16), idx, dest, w)
    log(f"kernel check coo_pool_rows bf16 table: ok (max abs err {e3:.3e})")

    # the library yardstick for K3: one embedding_bag call over the same
    # slots, whose (group, row) bags are contiguous (offsets from the
    # packer's counts); its output is in bag order, group-major
    tc = table.contiguous()
    idx64 = idx.long()
    cnt = torch.from_numpy(mapped[MHC_CNT].reshape(-1).astype(np.int64))
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(cnt, 0)[:-1]]).to(dev)
    bag = torch.nn.functional.embedding_bag(idx64, tc, offsets, mode="sum", per_sample_weights=w)
    ng = len(model.mh_coo_groups())
    held("embedding_bag yardstick", bag.reshape(ng, EB, k).transpose(0, 1).reshape(g, k),
         CP.coo_pool_rows_plain(table, idx, dest, w, g),
         CP.coo_pool_rows_plain(table.abs(), idx, dest, w.abs(), g))

    # K1 and K2 at this point's S, above the JAX package's 49,152-row
    # cap, where it runs an XLA gather forward and the lane-packed
    # accumulate_rows_packed backward: the lookup of the 14 single-valued
    # fields into the w columns of the [S, 3K] store, and its cotangent;
    # K1 also on the m columns (su[:, 16:32], 16-byte aligned) and on
    # su[:, 1:17] (4 bytes past it: the word path)
    ids = pt["ids"]
    n2 = ids.shape[0]
    for lo in (0, 16, 1):
        k1_exact("at the ESMM point", pt["store"], lo, k, ids)
    g2 = torch.randn((n2, k), generator=gen, device=dev)
    e2 = held("accumulate_rows at the ESMM point", SR.accumulate_rows(g2, ids, s),
              SR.accumulate_rows_plain(g2, ids, s), SR.accumulate_rows_plain(g2.abs(), ids, s))
    # both move the ids, the [S, K] rows and the [N, K] rows once
    b12 = (n2 * k * 4 + n2 * 4 + s * k * 4) / HBM_BYTES_PER_S * 1e3
    zeros = torch.zeros((s, k), device=dev)
    log(f"kernel expand_rows at the ESMM point (S={s}, N={n2}, K={k}, table row stride "
        f"{table.stride(0)}; where the TPU runs an XLA gather): max_abs_err 0 (bit-exact)  "
        f"{cuda_ms(lambda: SR.expand_rows(table, ids)):.4f} ms  "
        f"plain {cuda_ms(lambda: SR.expand_rows_plain(table, ids)):.4f} ms  "
        f"library (index_select) {cuda_ms(lambda: torch.index_select(table, 0, ids)):.4f} ms  "
        f"bound {b12:.4f} ms (bytes)")
    k2 = "accumulate_rows (ESMM point)"
    t2 = (cuda_ms(lambda: SR.accumulate_rows(g2, ids, s)),
          cuda_ms(lambda: SR.accumulate_rows_plain(g2, ids, s)),
          cuda_ms(lambda: torch.index_add(zeros, 0, ids, g2)))
    tile = SR._lib().tr_accumulate_rows_tile()
    slots, tiles = longest_chain(ids, tile)
    log(f"kernel {k2} (S={s}, N={n2}, K={k}; covers the TPU's accumulate_rows_packed): "
        f"max_abs_err {e2:.3e}  {t2[0]:.4f} ms  plain {t2[1]:.4f} ms  library (index_add) "
        f"{t2[2]:.4f} ms  bound {b12:.4f} ms (bytes); longest chain {slots} slots on one id, "
        f"held by {tiles} of {-(-n2 // tile)} tiles")

    # K4 at the edges of the sort-and-reduce: one tile on one id, M = T - 1,
    # T, T + 1 at K = 5, 16, 17, 48
    tile4 = CP._lib().tr_coo_accumulate_rows_tile()
    for name, m2, k4, one in [("one tile on one id", tile4, k, True)] + [
            (f"M={m2} K={k4}", m2, k4, False) for m2 in (tile4 - 1, tile4, tile4 + 1)
            for k4 in (5, 16, 17, 48)]:
        i4 = (torch.full((m2,), 3, dtype=torch.int32, device=dev) if one else
              torch.randint(0, 300, (m2,), generator=gen, device=dev, dtype=torch.int32))
        d4 = torch.randint(0, 64, (m2,), generator=gen, device=dev, dtype=torch.int32)
        w4 = torch.where(torch.rand(m2, generator=gen, device=dev) < 0.1, 0.0,
                         torch.rand(m2, generator=gen, device=dev) + 0.5)
        p4 = torch.randn((64, k4), generator=gen, device=dev)
        held(f"coo_accumulate_rows {name}", CP.coo_accumulate_rows(p4, i4, d4, w4, 300),
             CP.coo_accumulate_rows_plain(p4, i4, d4, w4, 300),
             CP.coo_accumulate_rows_plain(p4.abs(), i4, d4, w4.abs(), 300))
    log(f"kernel check coo_accumulate_rows edges (T={tile4}): one tile on one id, M = T-1, T, "
        "T+1 at K = 5, 16, 17, 48 ok")
    t = {
        "coo_pool_rows": (
            cuda_ms(lambda: CP.coo_pool_rows(table, idx, dest, w, g)),
            cuda_ms(lambda: CP.coo_pool_rows_plain(table, idx, dest, w, g)),
            cuda_ms(lambda: torch.nn.functional.embedding_bag(
                idx64, tc, offsets, mode="sum", per_sample_weights=w))),
        "coo_accumulate_rows": (
            cuda_ms(lambda: CP.coo_accumulate_rows(dp, idx, dest, w, s)),
            cuda_ms(lambda: CP.coo_accumulate_rows_plain(dp, idx, dest, w, s)),
            cuda_ms(lambda: torch.index_add(zeros, 0, idx, dp.index_select(0, dest) * w[:, None]))),
    }
    # least time: the three slot arrays, the table rows and the pooled
    # rows each moved once (the products are ~M*K FMAs, far below the
    # f32 rate)
    nbytes = m * 12 + s * k * 4 + g * k * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * k / F32_FLOPS * 1e3
    bound, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    lib_name = {"coo_pool_rows": "embedding_bag", "coo_accumulate_rows": "index_select*w + index_add"}
    for name in t:
        ms, plain, lib = t[name]
        log(f"kernel {name}: max_abs_err {err[name]:.3e}  {ms:.4f} ms  plain {plain:.4f} ms  "
            f"library ({lib_name[name]}) {lib:.4f} ms  bound {bound:.4f} ms ({bound_by}: "
            f"{nbytes / 1e6:.1f} MB, {2 * m * k / 1e6:.1f} MFLOP)")
    # what sets K3: its reductions, its time with none sent (an all-zero
    # table, built outside the timed calls), and the wrapper's zero fill
    r = pool_reductions(dest, w, k)
    zt = torch.zeros((s, 3 * k), device=dev)[:, :k]  # the same view, every row 0
    t_zero = cuda_ms(lambda: CP.coo_pool_rows(zt, idx, dest, w, g))
    t_fill = cuda_ms(lambda: torch.zeros((g, k), device=dev))
    n_live = int((w != 0).sum())
    log(f"kernel coo_pool_rows reductions into device memory: first (flat-walk) design "
        f"{r[0]} scalar atomics, longest chain {r[1]} on one address; this design (strip "
        f"{K3_STRIP}) {r[2]} vector reductions, longest chain {r[3]} (sums of exactly 0 "
        f"skipped); on an all-zero table, with no reduction sent, {t_zero:.4f} ms; the "
        f"wrapper's zero fill alone {t_fill:.4f} ms; table rows gathered {n_live} x "
        f"{k * 4} B = {n_live * k * 4 / 1e6:.1f} MB")
    slots, tiles = longest_chain(idx, tile4, live=w != 0)
    log(f"kernel coo_accumulate_rows: longest chain {slots} live slots on one id, held by "
        f"{tiles} of {-(-m // tile4)} tiles")
    bounds = {n: bound for n in t}
    t[k2], bounds[k2], err[k2] = t2, b12, e2
    return {"t": t, "bound": bounds, "bound_by": {n: bound_by for n in t} | {k2: "bytes"},
            "err": err}


def din_chain(model, sorted_aux):
    """The CLI's host chain for DIN --mh_coo training batches: the width
    bucketer, the COO packer (no combine: the attention is nonlinear in
    w; the compact segment stream, and the idx-sorted stream when asked),
    then the dedup mapper."""
    bucketer = MhPadBucketer(MH_PAIRS, DIN_WIDTH["mh_bucket"])
    packer = MhCooPacker(model.mh_coo_groups(), cdest_aux=True, sorted_aux=sorted_aux)
    mapper = SparseBatchMapper(model.sparse_slots())
    return lambda b: mapper(packer(bucketer(dict(b))))


def din_point(dev):
    """One DIN batch at the published point through the port's host chain
    (bucketer, packer with both aux streams, mapper), and K5's inputs on
    the card: at n_out = G the pool's values, zero on the padding slots;
    at n_out = Su the cotangent gathered into idx-sorted order and masked
    past the live count, as the --coo_sorted_bwd backward does."""
    model = create_model(Config(**DIN_WIDTH))
    raw = esmm_batches(1)[0]
    mapped = din_chain(model, sorted_aux=True)(raw)
    cdest, idx, perm, cidx, srows = (torch.from_numpy(mapped[key].reshape(-1)).to(dev) for key in
                                     (MHC_CDEST, MHC_IDX, MHC_PERM, MHC_CIDX, MHC_SROWS))
    m, m_live = idx.shape[0], int(mapped[MHC_CNT].sum())
    k = DIN_WIDTH["embedding_size"]
    gen = torch.Generator(device=dev).manual_seed(4)
    live = (torch.arange(m, device=dev) < m_live)[:, None]
    vals = torch.where(live, torch.randn((m, k), generator=gen, device=dev), 0.0)
    sct = torch.where(live, torch.randn((m, k), generator=gen, device=dev).index_select(0, perm), 0.0)
    return dict(model=model, raw=raw, mapped=mapped, cdest=cdest, idx=idx, perm=perm, cidx=cidx,
                srows=srows, m=m, m_live=m_live, k=k, gen=gen, vals=vals, sct=sct,
                g=EB * len(model.mh_coo_groups()), su=srows.shape[0])


K5_STRIP = 32  # slots one K5 thread sums (csrc/sorted_seg.cu STRIP)


def segsum_reductions(vals, cdest):
    """What one K5 launch sends to device memory, counted on the host from
    its inputs: a run is the slots of one strip between changes of cdest.
    Returns (scalar, chain_scalar, vector, chain_vector): a scalar
    design's atomics (32-slot strips, one per run and column, zero sums
    included) and the most of them on one address; this design's
    reductions and the most of them on one address. In this design a
    block sums 256 // groups strips of K5_STRIP slots (groups: K's
    column groups of four); a run on the block's first or last segment
    adds into shared memory, and the block adds each such segment's group
    once; any other run adds its group itself (one float4 at K % 4 == 0);
    nothing is added for a group whose values are all 0."""
    c = cdest.cpu().numpy().astype(np.int64)
    a = vals.float().abs().cpu().numpy()
    m, k = a.shape
    groups = -(-k // 4)

    def runs(n):
        starts = np.flatnonzero((np.arange(m) % n == 0)
                                | np.concatenate([[True], c[1:] != c[:-1]]))
        return starts, c[starts]

    starts, dest = runs(32)
    scalar, chain_scalar = starts.size * k, int(np.bincount(dest).max())
    starts, dest = runs(K5_STRIP)
    nz = np.add.reduceat(np.pad(a, ((0, 0), (0, 4 * groups - k))), starts, axis=0)
    nz = nz.reshape(-1, groups, 4).sum(axis=2)  # [runs, groups]: 0 iff all values 0
    span = K5_STRIP * max(1, 256 // groups)
    blk = starts // span
    first = c[blk * span]
    last = c[np.minimum(m, (blk + 1) * span) - 1]
    edge = (dest == first) | (dest == last)
    # the edge runs, summed per (block, first or last segment)
    key = blk[edge] * 2 + (dest[edge] != first[edge])
    ukey, inv = np.unique(key, return_inverse=True)
    edge_nz = np.zeros((ukey.size, groups))
    np.add.at(edge_nz, inv, nz[edge])
    edge_dest = np.where(ukey % 2 == 0, c[(ukey // 2) * span],
                         c[np.minimum(m, (ukey // 2 + 1) * span) - 1])
    adds = np.concatenate([nz[~edge] > 0, edge_nz > 0])
    dests = np.concatenate([dest[~edge], edge_dest])
    hits = np.bincount((dests[:, None] * groups + np.arange(groups)).ravel(), weights=adds.ravel())
    return scalar, chain_scalar, int(adds.sum()), int(hits.max())


def din_kernel_phase(dev):
    pt = din_point(dev)
    model, raw, mapped, gen = pt["model"], pt["raw"], pt["mapped"], pt["gen"]
    cdest, idx, cidx, vals, sct = pt["cdest"], pt["idx"], pt["cidx"], pt["vals"], pt["sct"]
    m, m_live, k, g, su = pt["m"], pt["m_live"], pt["k"], pt["g"], pt["su"]
    vocab = DIN_WIDTH["feature_size"]
    s = int(mapped["__uids_emb"].shape[0])
    uniq = int((mapped["__uids_emb"] < vocab).sum())
    su_live = int(mapped[MHC_CIDX][0, m_live - 1]) + 1
    log(f"DIN host shapes: {m_live} live COO slots over {len(model.mh_coo_groups())} groups, "
        f"no combine (COO bucket M={m}); {int((mapped[MHC_CNT] > 0).sum())} non-empty bags of "
        f"G={g}; {uniq} unique ids (uids bucket S={s}); {su_live} idx-sorted runs (bucket "
        f"Su={su}); a_int bucketed width {mapped['a_intids'].shape[1]}; K={k}")
    src = torch.randn((g, k), generator=gen, device=dev)

    def seg_err(name, v, c, n_out):
        return held(name, SG.sorted_segsum(v, c, n_out), SG.sorted_segsum_plain(v, c, n_out),
                    SG.sorted_segsum_plain(v.abs(), c, n_out))

    err = {"sorted_segsum": seg_err("sorted_segsum at n_out=G", vals, cdest, g),
           "sorted_segsum (n_out=Su)": seg_err("sorted_segsum at n_out=Su", sct, cidx, su)}
    e_bf = seg_err("sorted_segsum bf16 values", vals.to(torch.bfloat16), cdest, g)
    e_pad = seg_err("sorted_segsum all-padding stream", torch.zeros((m - m_live, k), device=dev),
                    torch.zeros(m - m_live, dtype=torch.int32, device=dev), g)
    check(torch.equal(SG.sorted_expand(src, cdest), SG.sorted_expand_plain(src, cdest)),
          "sorted_expand differs from src[cdest]")
    sb = src.to(torch.bfloat16)
    check(torch.equal(SG.sorted_expand(sb, cdest), sb[cdest]), "sorted_expand bf16")
    err["sorted_expand"] = 0.0
    log(f"kernel check sorted_segsum bf16 values ok (max abs err {e_bf:.3e}); all-padding "
        f"stream M={m - m_live} ok ({e_pad:.3e}); sorted_expand bit-exact in f32 and bf16")

    zg, zs = torch.zeros((g, k), device=dev), torch.zeros((su, k), device=dev)
    t = {
        "sorted_segsum": (cuda_ms(lambda: SG.sorted_segsum(vals, cdest, g)),
                          cuda_ms(lambda: SG.sorted_segsum_plain(vals, cdest, g)),
                          cuda_ms(lambda: torch.index_add(zg, 0, cdest, vals))),
        "sorted_segsum (n_out=Su)": (cuda_ms(lambda: SG.sorted_segsum(sct, cidx, su)),
                                     cuda_ms(lambda: SG.sorted_segsum_plain(sct, cidx, su)),
                                     cuda_ms(lambda: torch.index_add(zs, 0, cidx, sct))),
        "sorted_expand": (cuda_ms(lambda: SG.sorted_expand(src, cdest)),
                          cuda_ms(lambda: SG.sorted_expand_plain(src, cdest)),
                          cuda_ms(lambda: torch.index_select(src, 0, cdest))),
    }
    # least time: the [M, K] values or output, the [M] cdest and the
    # [n_out, K] rows each moved once (K5's M*K adds are far below the
    # f32 rate)
    nbytes = {"sorted_segsum": m * k * 4 + m * 4 + g * k * 4,
              "sorted_segsum (n_out=Su)": m * k * 4 + m * 4 + su * k * 4,
              "sorted_expand": m * 4 + g * k * 4 + m * k * 4}
    adds = {"sorted_segsum": m * k, "sorted_segsum (n_out=Su)": m * k, "sorted_expand": 0}
    bound = {n: max(b / HBM_BYTES_PER_S, adds[n] / F32_FLOPS) * 1e3 for n, b in nbytes.items()}
    lib_name = {"sorted_segsum": "index_add", "sorted_segsum (n_out=Su)": "index_add",
                "sorted_expand": "index_select"}
    red = {"sorted_segsum": segsum_reductions(vals, cdest),
           "sorted_segsum (n_out=Su)": segsum_reductions(sct, cidx)}
    # the same launches with no reduction sent: every sum is exactly 0
    zv, zsct = torch.zeros_like(vals), torch.zeros_like(sct)
    bare = {"sorted_segsum": cuda_ms(lambda: SG.sorted_segsum(zv, cdest, g)),
            "sorted_segsum (n_out=Su)": cuda_ms(lambda: SG.sorted_segsum(zsct, cidx, su))}
    for name in t:
        ms, plain, lib = t[name]
        log(f"kernel {name}: max_abs_err {err[name]:.3e}  {ms:.4f} ms  plain {plain:.4f} ms  "
            f"library ({lib_name[name]}) {lib:.4f} ms  bound {bound[name]:.4f} ms (bytes: "
            f"{nbytes[name] / 1e6:.1f} MB)")
        if name in red:
            r = red[name]
            log(f"kernel {name} reductions into device memory: scalar design {r[0]} atomics, "
                f"longest chain {r[1]} on one address; this design (strip {K5_STRIP}) {r[2]} "
                f"vector reductions, longest chain {r[3]} (sums of exactly 0 skipped); on "
                f"all-zero values, with no reduction sent, {bare[name]:.4f} ms")

    # K1 and K2 on the COO lookup of the slots without --coo_sorted_bwd
    # (N = M ids, padding on row 0): where the hot-row atomics showed
    store = torch.randn((s, 3 * k), generator=gen, device=dev)
    table = store[:, :k]
    k1_exact("at the DIN COO lookup", store, 0, k, idx)
    b12 = (m * k * 4 + m * 4 + s * k * 4) / HBM_BYTES_PER_S * 1e3
    log(f"kernel expand_rows at the DIN COO lookup (S={s}, N={m}, K={k}): bit-exact  "
        f"{cuda_ms(lambda: SR.expand_rows(table, idx)):.4f} ms  "
        f"plain {cuda_ms(lambda: SR.expand_rows_plain(table, idx)):.4f} ms  "
        f"library (index_select) {cuda_ms(lambda: torch.index_select(table, 0, idx)):.4f} ms  "
        f"bound {b12:.4f} ms (bytes)")
    # K2 on the COO lookup, and on the shared lookup in the step's own id
    # layout (the 11 common fields, the 3 scalar ad fields, the bucketed
    # a_intids block) with a cotangent that is exactly 0 on the a_int
    # padding slots, as the step's int_mask makes it (models/din.py)
    bucketed = MhPadBucketer(MH_PAIRS, DIN_WIDTH["mh_bucket"])(dict(raw))
    a_int_pad = torch.from_numpy(bucketed["a_intids"] <= 0).to(dev)
    fc = mapped["feat_ids"].shape[1] + 3
    shared = torch.from_numpy(np.concatenate(
        [mapped["feat_ids"]] + [mapped[f][:, None] for f in ("a_catids", "a_shopids", "a_brandids")]
        + [mapped["a_intids"]], axis=1).reshape(-1)).to(dev)
    g_sh = torch.randn((shared.shape[0] // EB, EB, k), generator=gen, device=dev).transpose(0, 1)
    g_sh = torch.where(torch.cat([torch.zeros((EB, fc), dtype=torch.bool, device=dev), a_int_pad],
                                 dim=1)[..., None], 0.0, g_sh).reshape(-1, k).contiguous()
    points = {"accumulate_rows (DIN COO lookup)": (torch.randn((m, k), generator=gen, device=dev), idx,
                                                   f"{m - m_live} padding ids on row 0"),
              "accumulate_rows (DIN shared lookup)": (g_sh, shared,
                                                      f"{int(a_int_pad.sum())} a_int padding slots, "
                                                      "cotangent 0")}
    tile = SR._lib().tr_accumulate_rows_tile()
    zs2 = torch.zeros((s, k), device=dev)
    for name, (g2, i2, what) in points.items():
        n2 = i2.shape[0]
        err[name] = held(name, SR.accumulate_rows(g2, i2, s), SR.accumulate_rows_plain(g2, i2, s),
                         SR.accumulate_rows_plain(g2.abs(), i2, s))
        t[name] = (cuda_ms(lambda: SR.accumulate_rows(g2, i2, s)),
                   cuda_ms(lambda: SR.accumulate_rows_plain(g2, i2, s)),
                   cuda_ms(lambda: torch.index_add(zs2, 0, i2, g2)))
        bound[name] = (n2 * k * 4 + n2 * 4 + s * k * 4) / HBM_BYTES_PER_S * 1e3
        slots, tiles = longest_chain(i2, tile)
        ms, plain, lib = t[name]
        log(f"kernel {name} (S={s}, N={n2}, K={k}, {what}): max_abs_err {err[name]:.3e}  "
            f"{ms:.4f} ms  plain {plain:.4f} ms  library (index_add) {lib:.4f} ms  bound "
            f"{bound[name]:.4f} ms (bytes); longest chain {slots} slots on one id, held by "
            f"{tiles} of {-(-n2 // tile)} tiles")
    return {"t": t, "bound": bound, "bound_by": "bytes", "err": err}


BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
ATT_W = 256  # DIN's attention width (DIN.py's default, the benchmark's din_aliccp)


def att_unit_work(n, k, w):
    """(forward, backward) least bytes and FLOPs of the attention unit over
    n slots: u and a read and the weight written; u, a, the weight's
    gradient and the weight read, du and da written. FLOPs: the first
    layer's GEMM and the output dot forward, twice both backward (the
    backward's recompute of the first layer is the design's, not the
    model's, and is not counted)."""
    fwd_flops = 2 * n * 3 * k * w + 2 * n * w
    return (2 * n * k * 4 + n * 4, fwd_flops), (4 * n * k * 4 + 2 * n * 4, 2 * fwd_flops)


def host_us(fn, xs, calls: int = 300) -> float:
    """Host microseconds of a forward and backward of fn over the first 256
    rows of xs[0] and xs[1] (the card's share of such a call is a few
    microseconds), synchronized once after the calls."""
    small = [(x[:256] if i < 2 else x).detach().clone().requires_grad_(True)
             for i, x in enumerate(xs)]

    def once():
        y = fn(*small)
        return torch.autograd.grad(y, small, torch.ones_like(y))

    for _ in range(10):
        once()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        once()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def att_unit_point(dev, label, n, k, m_live, gen):
    """The fused unit against att_unit_plain at one point (the forward
    weight per slot to a quarter of one bf16 ulp of sum_c |w2_c h_c|, each
    gradient normwise to one bf16 ulp, as tests/test_torch_att_unit.py),
    then each alone and the two compositions timed. Returns (ms, plain ms,
    bound ms, bound_by, max abs weight gap)."""
    mlp, _ = T.init_mlp(None, 3 * k, [ATT_W])
    out = T.init_dense(None, ATT_W, 1)
    dense = mlp["layers"][0]["dense"]
    dense["b"] = 0.1 * torch.randn(ATT_W)
    leaves = [x.to(dev) for x in (dense["w"], dense["b"], out["w"], out["b"])]
    live = (torch.arange(n, device=dev) < m_live)[:, None]
    # d = w * emb is 0 on the COO padding slots, as in the step
    u = torch.where(live, torch.randn((n, k), generator=gen, device=dev), 0.0)
    a = torch.randn((n, k), generator=gen, device=dev)
    gw = torch.randn((n,), generator=gen, device=dev)

    def plain(u, a, w1, b1, w2, b2):
        m = {"layers": [{"dense": {"w": w1, "b": b1}}]}
        return AU.att_unit_plain(m, {"layers": [{}]}, {"w": w2, "b": b2}, u, a, keep_probs=[1.0],
                                 train=True, generator=None, compute_dtype="bfloat16")[0]

    xs = [t.detach().clone().requires_grad_(True) for t in (u, a, *leaves)]

    def both(fn):
        y = fn(*xs)
        return y, torch.autograd.grad(y, xs, gw)

    y1, g1 = both(AU.att_unit)
    y0, g0 = both(plain)
    torch.cuda.synchronize()
    _, _, h = AU.first_layer(u, a, leaves[0])
    scale = (torch.relu(h + leaves[1]) * leaves[2][:, 0]).abs().sum(1)
    del h
    gap = (y1 - y0).detach().abs()
    check(bool((gap <= 0.25 * 2.0 ** -8 * scale + 1e-6).all()),
          f"att_unit {label}: weight differs, max abs {float(gap.max())}")
    rel = {}
    for name, x0, x1 in zip(("du", "da", "dw1", "db1", "dw2", "db2"), g0, g1):
        ref = float(torch.linalg.vector_norm(x0))
        rel[name] = float(torch.linalg.vector_norm(x1 - x0)) / max(ref, 1e-30)
        check(rel[name] <= 2.0 ** -8, f"att_unit {label}: {name} differs, normwise {rel[name]:.3e}")
    s = y1.detach()
    fwd = cuda_ms(lambda: AU.att_unit_forward(u, a, *leaves))
    bwd = cuda_ms(lambda: AU.att_unit_backward(gw, u, a, s, *leaves[:3]))
    with torch.no_grad():
        plain_fwd = cuda_ms(lambda: plain(u, a, *leaves))
    fused_step = cuda_ms(lambda: both(AU.att_unit))
    plain_step = cuda_ms(lambda: both(plain))
    host = {"fused": host_us(AU.att_unit, xs), "plain": host_us(plain, xs)}
    (fb, ff), (bb, bf) = att_unit_work(n, k, ATT_W)
    bounds = {"forward": (fb / HBM_BYTES_PER_S, ff / BF16_FLOPS),
              "backward": (bb / HBM_BYTES_PER_S, bf / BF16_FLOPS)}
    bound = sum(max(b) for b in bounds.values()) * 1e3
    by = "bytes" if all(b[0] >= b[1] for b in bounds.values()) else "FLOPs"
    log(f"kernel att_unit {label} (N={n}, {m_live} live, K={k}, W={ATT_W}): forward {fwd:.4f} ms, "
        f"backward (with its reduce) {bwd:.4f} ms; bound forward "
        f"{max(bounds['forward']) * 1e3:.4f} ms ({fb / 1e6:.1f} MB, {ff / 1e9:.1f} GFLOP), backward "
        f"{max(bounds['backward']) * 1e3:.4f} ms ({bb / 1e6:.1f} MB, {bf / 1e9:.1f} GFLOP), "
        f"{100 * bound / (fwd + bwd):.1f}% of it; forward + backward through autograd: fused "
        f"{fused_step:.4f} ms, plain composition {plain_step:.4f} ms (its forward alone "
        f"{plain_fwd:.4f} ms); host us a forward + backward at 256 slots: fused "
        f"{host['fused']:.1f}, plain {host['plain']:.1f}; weight max abs gap "
        f"{float(gap.max()):.3e}, gradients normwise "
        + ", ".join(f"{k2} {v:.2e}" for k2, v in rel.items()))
    return fwd + bwd, plain_step, bound, by, float(gap.max())


def att_unit_kernel_phase(dev):
    """The fused attention unit alone: at the smoke's DIN point (the COO
    bucket of one published Ali-CCP batch, K=16, the DIN main path's
    width) and at the benchmark cell's (N=1,572,864, K=32)."""
    pt = din_point(dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    t, bound, by, err = {}, {}, {}, {}
    points = {"att_unit": ("at the DIN point", pt["m"], pt["k"], pt["m_live"]),
              "att_unit (benchmark point)": ("at the benchmark point", 1_572_864, 32, 1_372_160)}
    for name, (label, n, k, m_live) in points.items():
        ms, plain, bound[name], by[name], err[name] = att_unit_point(dev, label, n, k, m_live, gen)
        t[name] = (ms, plain, None)
    return {"t": t, "bound": bound, "bound_by": by, "err": err}


def step_graph_only(dev) -> int:
    """--only=step_graph: the bare DeepFM and DIN steps as CUDA graphs and
    eagerly, then the DeepFM and DIN card-vs-CPU trajectories (the first
    on graphs, the second eager for its replayed gates); no result line."""
    bare_steps(dev, None)
    din_bare_step(dev, None, False)
    trajectory(dev)
    din_trajectory(dev)
    log("the step graph alone (--only=step_graph): no result line")
    return 0


def att_unit_only(dev) -> int:
    """--only=att_unit: the fused attention unit's phase alone; no result
    line."""
    att_unit_kernel_phase(dev)
    log("the attention unit alone (--only=att_unit): no result line")
    return 0


def k1_k2_point(out, label, what, store, k, idx, s, gen):
    """K1 and K2 at one lookup point, their entries "expand_rows (label)" and
    "accumulate_rows (label)" added to ``out``: the table is the [S, K]
    view store[:, :k] (its row stride the store's width), idx the lookup's
    N ids. K1 bit-exact in f32 and bf16, K2 within 1e-4 * sum_i |g_i| +
    1e-6 per element (atomics: run-to-run sum order), each timed against
    its plain version and index_select / index_add, with its bound."""
    dev, n = idx.device, idx.shape[0]
    table = store[:, :k]
    k1_exact(f"({label})", store, 0, k, idx)
    err1 = float((SR.expand_rows(table, idx) - SR.expand_rows_plain(table, idx)).abs().max())
    g = torch.randn((n, k), generator=gen, device=dev)
    diff = (SR.accumulate_rows(g, idx, s) - SR.accumulate_rows_plain(g, idx, s)).abs()
    scale = SR.accumulate_rows_plain(g.abs(), idx, s)
    err2 = float(diff.max())
    check(bool((diff <= 1e-4 * scale + 1e-6).all()),
          f"accumulate_rows ({label}) differs: max abs err {err2}")
    zeros = torch.zeros((s, k), device=dev)
    e1, e2 = f"expand_rows ({label})", f"accumulate_rows ({label})"
    out["t"][e1] = (cuda_ms(lambda: SR.expand_rows(table, idx)),
                    cuda_ms(lambda: SR.expand_rows_plain(table, idx)),
                    cuda_ms(lambda: torch.index_select(table, 0, idx)))
    out["t"][e2] = (cuda_ms(lambda: SR.accumulate_rows(g, idx, s)),
                    cuda_ms(lambda: SR.accumulate_rows_plain(g, idx, s)),
                    cuda_ms(lambda: torch.index_add(zeros, 0, idx, g)))
    # least time: the ids, the [S, K] rows and the [N, K] rows each moved
    # once; K2's N*K adds are far below the f32 rate
    nbytes = n * 4 + s * k * 4 + n * k * 4
    out["bound"][e1] = nbytes / HBM_BYTES_PER_S * 1e3
    out["bound"][e2] = max(nbytes / HBM_BYTES_PER_S, n * k / F32_FLOPS) * 1e3
    out["bound_by"][e1] = out["bound_by"][e2] = "bytes"
    out["err"][e1], out["err"][e2] = err1, err2
    tile = SR._lib().tr_accumulate_rows_tile()
    slots, tiles = longest_chain(idx, tile)
    for e in (e1, e2):
        ms, plain, lib = out["t"][e]
        log(f"kernel {e}: {what}, S={s} N={n} K={k} (row stride {table.stride(0)}); "
            f"max_abs_err {out['err'][e]:.3e}  {ms:.4f} ms  plain {plain:.4f} ms  library "
            f"{lib:.4f} ms  bound {out['bound'][e]:.4f} ms (bytes: {nbytes / 1e6:.2f} MB; "
            f"{out['bound'][e] / ms:.2f} of it)")
    log(f"kernel accumulate_rows ({label}): longest chain {slots} slots on one id; "
        f"{tiles} of {-(-n // tile)} tiles of {tile} slots hold it")


def zoo_kernel_phase(dev):
    """K1 and K2 at the zoo's row widths (phase 3f): one Zipf(1.2) batch of
    the DeepFM point through each model's host dedup mapper, all 39 fields
    through the lookup (no static fields), the rows a [S, K] view of a
    [S, 3K] w|m|v store as on the main path: width 33 (the PNN family's
    [V, 1+32], row stride 99, words), 257 (NFM's and AFM's [V, 1+256],
    stride 771, words) at B=16,384 and at AFM's cut B=4,096, and 32
    (DCN's and DeepMVM's [V, 32], stride 96, 16-byte chunks), each as
    k1_k2_point holds and times it."""
    raw = zipf_batches(1, seed=11, batch=B)[0]
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {"t": {}, "bound": {}, "bound_by": {}, "err": {}}
    for point, (name, _) in ZOO_POINTS.items():
        b = zoo_width(name)["batch_size"]
        model = create_model(Config(**zoo_width(name)))
        (table_name,) = model.sparse_slots()
        mapped = SparseBatchMapper(model.sparse_slots())({k: v[:b] for k, v in raw.items()})
        s = int(mapped[UIDS_PREFIX + table_name].shape[0])
        idx = torch.from_numpy(np.ascontiguousarray(mapped["feat_ids"]).reshape(-1)).to(dev)
        k = ZOO[name]["embedding_size"] + (0 if table_name == "emb" else 1)
        su = torch.randn((s, 3 * k), generator=gen, device=dev)
        k1_k2_point(out, f"zoo, {point}", f"{name}'s lookup, B={b}", su, k, idx, s, gen)
        del su
    torch.cuda.empty_cache()
    return out


def unfused_kernel_phase(dev):
    """K1 and K2 on the unfused lazy row store (phase 3a, the other
    optimizers' path): the DeepFM point's batch and ids, the table a plain
    contiguous [S, 17] block (row stride 17, the word path) as the step
    gathers it from the [V+1, 17] store, as k1_k2_point holds and times
    it."""
    pt = deepfm_point(dev)
    out = {"t": {}, "bound": {}, "bound_by": {}, "err": {}}
    table = torch.randn((pt["s"], pt["k"]), generator=pt["gen"], device=dev)
    k1_k2_point(out, "unfused store, stride 17", f"DeepFM's lookup, B={B}", table, pt["k"],
                pt["idx"], pt["s"], pt["gen"])
    return out


def scatter_kernel_phase(dev):
    """K7 at the ESMM point: the uids of one batch through the port's chain
    (ascending, the sentinel V after the live ones), rows written into the
    lane-padded [V+1, 128] store of the ESMM path and, for a later choice of
    the card's row layout, into an unpadded [V+1, 48] one."""
    model = create_model(Config(**ESMM_WIDTH))
    vocab = ESMM_WIDTH["feature_size"]
    uids = esmm_chain(model)(esmm_batches(1)[0])["__uids_emb"]
    u = torch.from_numpy(uids).to(dev)
    s, live = u.shape[0], int((uids < vocab).sum())
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for width in (128, 48):
        store = torch.randn((vocab + 1, width), generator=gen, device=dev)
        store[-1] = 0.0
        rows = torch.randn((s, width), generator=gen, device=dev)
        want = RS.dma_row_scatter_plain(store.clone(), u, rows, vocab)
        RS.dma_row_scatter(store, u, rows, n_valid=vocab)
        torch.cuda.synchronize()
        check(torch.equal(store, want), f"dma_row_scatter at width {width} differs from the "
                                        "masked assignment")
        del want
        u_live, rows_live = u[:live].long(), rows[:live].contiguous()
        t = (cuda_ms(lambda: RS.dma_row_scatter(store, u, rows, n_valid=vocab)),
             cuda_ms(lambda: RS.dma_row_scatter_plain(store, u, rows, vocab), iters=10),
             cuda_ms(lambda: store.index_copy_(0, u_live, rows_live)))
        # least time: the live rows read and written once, the uids read
        nbytes = 2 * live * width * 4 + s * 4
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        # the step's row gather from the same store (train/sparse.take_rows)
        gather = cuda_ms(lambda: store.index_select(0, u))
        log(f"kernel dma_row_scatter at the ESMM point (store [{vocab + 1}, {width}] f32, S={s}, "
            f"{live} live): bit-exact  {t[0]:.4f} ms  plain {t[1]:.4f} ms  library (index_copy_) "
            f"{t[2]:.4f} ms  bound {bound:.4f} ms (bytes: {nbytes / 1e6:.1f} MB); the step's row "
            f"gather from this store (index_select) {gather:.4f} ms")
        out[width] = (t, bound)
        del store, rows, rows_live
    (t, bound) = out[128]
    return {"t": {"dma_row_scatter": t}, "bound": {"dma_row_scatter": bound}, "bound_by": "bytes",
            "err": {"dma_row_scatter": 0.0}}


def field_block_point(dev):
    """K8's inputs at the DeepFM point: one batch of the --field_blocks
    leg's data (per-field blocks) and a random f32 cotangent [B, 39, 17]."""
    vocab, w = WIDTH["feature_size"], 1 + WIDTH["embedding_size"]
    ids_np = synthetic_criteo_batch(np.random.default_rng(6), B, vocab)["feat_ids"]
    gen = torch.Generator(device=dev).manual_seed(6)
    g = torch.randn((B, len(FB_OFFSETS), w), generator=gen, device=dev)
    return ids_np, torch.from_numpy(ids_np).to(dev), g


def span_ops(a: int, n: int) -> int:
    """Reductions row_ops.cuh's emit_span issues for n floats starting a
    floats past a 16-byte boundary: a single float and a pair to the
    boundary, float4s, then a pair and a single float."""
    ops, j = 0, 0
    if a % 2 and n:
        ops, j = 1, 1
    if (a + j) % 4 == 2 and n - j >= 2:
        ops, j = ops + 1, j + 2
    ops, j = ops + (n - j) // 4, j + (n - j) // 4 * 4
    return ops + (j + 2 <= n) + ((n - j) % 2)


def field_block_reductions(ids_np, w):
    """What one K8 launch sends to device memory at the DeepFM point,
    counted on the host from the ids: (scalar, vector, hot_pairs, flush,
    chain). The live pairs of fields without a shared-memory accumulator
    add their rows straight into device memory: a scalar design with one
    atomic an element, this one with emit_span's 5-6 reductions a 17-float
    row. The pairs of the accumulated (one-row) fields add in shared
    memory; every block then adds its accumulator rows once (emit_span,
    32 floats a thread), so each such word takes a chain of one reduction
    per block."""
    table, _ = FB.field_plan(FB_OFFSETS, FB_SIZES, w)
    nf = len(FB_OFFSETS)
    off, size, base = (np.array(table[i * nf:(i + 1) * nf]) for i in range(3))
    rel = ids_np - off
    live = (rel >= 0) & (rel < size) & (ids_np < WIDTH["feature_size"])
    cold_ids = ids_np[live & (base < 0)].astype(np.int64)
    ops = np.array([span_ops(a, w) for a in range(4)])
    blocks = -(-ids_np.size // FB.PAIRS)
    flush = sum(span_ops((o * w + j) % 4, min(32, s * w - j))
                for o, s in zip(off[base >= 0], size[base >= 0]) for j in range(0, s * w, 32))
    return (int(cold_ids.size * w), int(ops[cold_ids * w % 4].sum()),
            int((live & (base >= 0)).sum()), blocks * int(flush), blocks)


def field_block_kernel_phase(dev):
    """K8 at the DeepFM point (field_block_point), in bf16 (the harness's
    mode) and f32 mode, plus a case with out-of-block ids and -1 padding
    rows."""
    vocab, w = WIDTH["feature_size"], 1 + WIDTH["embedding_size"]
    ids_np, ids, g = field_block_point(dev)

    def err(name, i, use_bf16):
        args = (vocab, FB_OFFSETS, FB_SIZES, use_bf16)
        return held(name, FB.field_block_scatter(i, g, *args), FB.field_block_scatter_plain(i, g, *args),
                    FB.field_block_scatter_plain(i, g.abs(), *args))

    e = {mode: err(f"field_block_scatter {mode}", ids, mode == "bf16") for mode in ("bf16", "f32")}
    masked = ids_np.copy()
    masked[: B // 2, 13:] = np.random.default_rng(7).integers(0, vocab, size=(B // 2, 26))
    masked[-512:] = -1
    e_m = err("field_block_scatter out-of-block and -1 ids", torch.from_numpy(masked).to(dev), True)
    log(f"kernel check field_block_scatter: bf16 max abs err {e['bf16']:.3e}, f32 {e['f32']:.3e}, "
        f"out-of-block and -1 ids {e_m:.3e}")
    # the library yardstick: one index_add_ of the masked, rounded rows
    i64 = ids.long()
    off = torch.tensor(FB_OFFSETS, device=dev)
    keep = (i64 >= off) & (i64 < off + torch.tensor(FB_SIZES, device=dev))
    lib_ids = torch.where(keep, i64, 0).reshape(-1)
    lib_g = torch.where(keep[..., None], g.to(torch.bfloat16).float(), 0.0).reshape(-1, w)
    args = (vocab, FB_OFFSETS, FB_SIZES, True)
    t = (cuda_ms(lambda: FB.field_block_scatter(ids, g, *args)),
         cuda_ms(lambda: FB.field_block_scatter_plain(ids, g, *args)),
         cuda_ms(lambda: torch.zeros((vocab, w), device=dev).index_add_(0, lib_ids, lib_g)))
    # least time: ids and g read once, dtable written once (zeroing it
    # first is a cost of the atomic design, not of the function; the
    # B*F*W adds are far below the f32 rate)
    nbytes = ids.numel() * 4 + g.numel() * 4 + vocab * w * 4
    bound = max(nbytes / HBM_BYTES_PER_S, g.numel() / F32_FLOPS) * 1e3
    log(f"kernel field_block_scatter (B={B}, F={len(FB_OFFSETS)}, W={w}, vocab {vocab}, 13 one-row "
        f"blocks + 26 of {FB_BLOCK}; bf16 mode): max_abs_err {e['bf16']:.3e}  {t[0]:.4f} ms  "
        f"plain {t[1]:.4f} ms  library (index_add_) {t[2]:.4f} ms  bound {bound:.4f} ms (bytes: "
        f"{nbytes / 1e6:.1f} MB)")
    scalar, vector, hot, flush, chain = field_block_reductions(ids_np, w)
    # the same launch with every pair dropped: g streams through, nothing is added
    dropped = torch.full_like(ids, -1)
    bare = cuda_ms(lambda: FB.field_block_scatter(dropped, g, *args))
    log(f"kernel field_block_scatter reductions into device memory: scalar design {scalar} "
        f"atomics, this design {vector} vector reductions (emit_span); {hot} pairs of the "
        f"accumulated one-row fields add in shared memory, then {flush} flush reductions, a "
        f"chain of {chain} (one a block, {FB.PAIRS} pairs a block) on each accumulated word; "
        f"with every id -1, so that nothing is added, {bare:.4f} ms")
    return {"t": {"field_block_scatter": t}, "bound": {"field_block_scatter": bound},
            "bound_by": "bytes", "err": {"field_block_scatter": e["bf16"]}}


# ------------------------------------------------------------------ phase 4
def deepfm_host_timings(path):
    """The libsvm parse of one 16,384-line DeepFM batch on this host: the
    plain Python parser and the native blob parser (one thread each),
    which must agree (ids and labels exactly, values to 1e-6 relative)."""
    with open(path, "rb") as f:
        lines = [next(f) for _ in range(B)]
    blob = b"".join(lines)
    t_py, (ids, vals, labels) = best_s(lambda: parse_libsvm_lines(lines, WIDTH["field_size"]), 1)
    t_nat, (n_ids, n_vals, n_labels) = best_s(lambda: native.parse_libsvm_blob(blob, WIDTH["field_size"]))
    check(np.array_equal(ids, n_ids) and np.array_equal(labels, n_labels)
          and np.allclose(vals, n_vals, rtol=1e-6, atol=0), "native libsvm parse differs from the plain one")
    log(f"host input (os.cpu_count()={os.cpu_count()}), DeepFM, per {B}-line batch: Python parse "
        f"{t_py * 1e3:.1f} ms, native blob parse {t_nat * 1e3:.2f} ms (one thread each; equal)")
    return {"deepfm python parse ms": t_py * 1e3, "deepfm native parse ms": t_nat * 1e3}


def write_in_parts(kind, path, rows, seed, **kw):
    """A synthetic training file from one writer process a host core, all
    started together (the writers draw a line at a time in Python), each
    writing a part of the rows from its own seed (seed + part), the parts
    then joined into ``path``. kind: "libsvm" or "aliccp" (the published
    multi-hot lengths)."""
    parts = max(1, min(8, (os.cpu_count() or 2) - 1))
    code = ("import json, sys; from tf_repos_tpu_torch.data import synthetic as S; "
            "kw = json.loads(sys.argv[4]); "
            "kw.update(mh_avg_lens=S.PUBLISHED_MH_AVG_LENS) if sys.argv[1] == 'aliccp' else None; "
            "getattr(S, 'write_synthetic_' + sys.argv[1])(sys.argv[2], int(sys.argv[3]), **kw)")
    sizes = [rows // parts + (i < rows % parts) for i in range(parts)]
    names = [f"{path}.part{i}" for i in range(parts)]
    procs = [subprocess.Popen([sys.executable, "-c", code, kind, name, str(n),
                               json.dumps(dict(kw, seed=seed + i))], cwd=HERE)
             for i, (name, n) in enumerate(zip(names, sizes))]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rcs == [0] * parts, f"the {kind} writers exited {rcs}")
    with open(path, "wb") as out:
        for name in names:
            with open(name, "rb") as f:
                shutil.copyfileobj(f, out, 1 << 24)
            os.remove(name)


def main_path(dev, work, rates):
    data = os.path.join(work, "data")
    os.makedirs(data)
    t0 = time.perf_counter()
    write_in_parts("libsvm", os.path.join(data, "tr.libsvm"), MAIN_STEPS * B, 1,
                   feature_size=WIDTH["feature_size"], zipf_a=1.2)
    write_synthetic_libsvm(os.path.join(data, "va.libsvm"), B, WIDTH["feature_size"],
                           seed=2, zipf_a=1.2)
    log(f"main path data: {MAIN_STEPS * B} train + {B} valid rows written in "
        f"{time.perf_counter() - t0:.1f} s")
    rates.update(deepfm_host_timings(os.path.join(data, "tr.libsvm")))
    argv = [f"--{k}={v}" for k, v in WIDTH.items()] + [
        "--task_type=train", "--num_epochs=1", "--log_steps=7", f"--data_dir={data}",
        f"--model_dir={work}/model/", "--dt_dir=smoke", "--eval_throttle_secs=0",
        f"--device={dev.type}", "--seed=2018",
    ]
    SR.reset_launches()
    t0 = time.perf_counter()
    with StepClock() as clock:
        res = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"expand_rows": SR.expand_rows.launches,
                "accumulate_rows": SR.accumulate_rows.launches}
    rates["DeepFM CLI"] = clock.ex_per_s(B)
    rates["DeepFM CLI host"] = host_rate(argv, B)
    log(f"main path: {res['step']} steps in {wall:.1f} s wall, launches {launches}; native blob "
        f"parse on {max(1, min(16, (os.cpu_count() or 4) - 1))} threads; CLI "
        f"{rates['DeepFM CLI']:.0f} examples/s; its input alone {rates['DeepFM CLI host']:.0f}")
    check(res["step"] >= 20, f"main path ran {res['step']} steps")
    check(math.isfinite(res["loss"]) and 0.0 <= res["auc"] <= 1.0, f"main path result {res}")
    for name, c in launches.items():
        check(c > 0, f"{name} was not launched on the main path")
    check(launches["accumulate_rows"] == res["step"],
          f"accumulate_rows launched {launches['accumulate_rows']} times in {res['step']} steps, "
          "expected one a step")
    return launches


def esmm_host_timings(path):
    """The host chain of one 4096-line ESMM batch on this host: the plain
    Python and the native Ali-CCP parse (which must be bit-equal), the
    COO packer with combine on the plain np.unique combine and on the
    native one (the same streams in the same order, weights within
    1e-5 relative: f64 sums against f32 ones), and the dedup mapper."""
    p = ESMM_WIDTH["multi_hot_pad"]
    with open(path, "rb") as f:
        lines = [next(f) for _ in range(EB)]
    model = create_model(Config(**ESMM_WIDTH))
    t = {}
    t["python parse"], plain = best_s(lambda: parse_aliccp_lines(lines, p), 1)
    t["native parse"], batch = best_s(lambda: native.parse_aliccp_lines(lines, p))
    check(plain.keys() == batch.keys() and all(np.array_equal(plain[k], batch[k]) for k in plain),
          "native Ali-CCP parse differs from the plain one")
    packed = {}
    for name, nat in (("packer, np.unique combine", False), ("packer, native combine", True)):
        packer = MhCooPacker(model.mh_coo_groups(), combine=True, use_native=nat)
        t[name], packed[nat] = best_s(lambda: packer(dict(batch)))
    a, b = packed[False], packed[True]
    check(np.array_equal(a[MHC_IDX], b[MHC_IDX]) and np.array_equal(a[MHC_DEST], b[MHC_DEST])
          and np.allclose(a[MHC_W], b[MHC_W], rtol=1e-5, atol=0),
          "the packer's streams differ between the plain and the native combine")
    mapper = SparseBatchMapper(model.sparse_slots())
    t["mapper"], _ = best_s(lambda: mapper(dict(packed[True])))
    log(f"host input (os.cpu_count()={os.cpu_count()}), ESMM, per {EB}-line batch at pad {p}: "
        + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in t.items())
        + f"; {int(b[MHC_CNT].sum())} live COO slots after the combine")
    return {f"esmm {k} ms": v * 1e3 for k, v in t.items()}


def esmm_cli(argv, label):
    """One ESMM CLI run with the launch counters zeroed just before and read
    just after: K2, K4 and K7 once a step, every path kernel launched.
    Returns (result, launches, CLI examples/s)."""
    for mod in (SR, CP, RS):
        mod.reset_launches()
    t0 = time.perf_counter()
    with StepClock() as clock:
        res = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in (SR.expand_rows, SR.accumulate_rows,
                                                CP.coo_pool_rows, CP.coo_accumulate_rows,
                                                RS.dma_row_scatter)}
    launches["accumulate_rows (ESMM point)"] = launches["accumulate_rows"]
    rate = clock.ex_per_s(EB)
    log(f"{label}: {res['step']} steps in {wall:.1f} s wall, launches {launches}; CLI "
        f"{rate:.0f} examples/s")
    check(res["step"] >= ESMM_STEPS, f"{label} ran {res['step']} steps")
    for name in ("accumulate_rows", "coo_accumulate_rows"):
        check(launches[name] == res["step"], f"{label}: {name} launched {launches[name]} times in "
                                             f"{res['step']} steps, expected one a step")
    check(launches["dma_row_scatter"] == res["step"],
          f"{label}: dma_row_scatter launched {launches['dma_row_scatter']} times in "
          f"{res['step']} steps, expected one write-back a step")
    check(math.isfinite(res["loss"]), f"{label} loss {res['loss']}")
    for name in ("CTR_AUC", "CVR_AUC", "CTCVR_AUC"):
        check(0.0 <= res.get(name, -1.0) <= 1.0, f"{label} {name}: {res}")
    for name, c in launches.items():
        check(c > 0, f"{name} was not launched on the {label}")
    return res, launches, rate


def last_train_loss(model_dir):
    with open(os.path.join(model_dir, "smoke", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r["loss"] for r in recs if r["kind"] == "train"][-1]


def esmm_main_path(dev, work, rates):
    """ESMM through the CLI with the native host input, --map_workers=2 and
    --packed_cache: a first run that parses the text and writes the
    cache (the main path whose launches the report counts), a second that
    must read it and write nothing, and the same steps with
    --map_workers=1 on the cache, whose loss must match the second run's
    within 1e-4 relative."""
    data = os.path.join(work, "esmm_data")
    os.makedirs(data)
    tr = os.path.join(data, "tr.samples.txt")
    t0 = time.perf_counter()
    write_in_parts("aliccp", tr, ESMM_STEPS * EB, 1, feature_size=ESMM_WIDTH["feature_size"],
                   zipf_a=1.2)
    write_synthetic_aliccp(os.path.join(data, "va.samples.txt"), EB, ESMM_WIDTH["feature_size"],
                           seed=2, zipf_a=1.2, mh_avg_lens=PUBLISHED_MH_AVG_LENS)
    log(f"ESMM main path data: {ESMM_STEPS * EB} train + {EB} valid lines "
        f"({os.path.getsize(tr) / 2**20:.0f} MiB of train text) written in "
        f"{time.perf_counter() - t0:.1f} s")
    rates.update(esmm_host_timings(tr))
    log(f"ESMM: --multi_hot_pad=0 (auto_multi_hot_pad) would pick a pad of {auto_multi_hot_pad([tr])} "
        f"for these lines; the cell runs at {ESMM_WIDTH['multi_hot_pad']}")
    argv = [f"--{k}={v}" for k, v in ESMM_WIDTH.items()] + [
        "--task_type=train", "--num_epochs=1", "--log_steps=5", f"--data_dir={data}",
        "--dt_dir=smoke", "--eval_throttle_secs=0", f"--device={dev.type}", "--seed=2018",
        "--map_workers=2", "--packed_cache=true",
    ]
    res, launches, rates["ESMM CLI, cache build"] = esmm_cli(
        [*argv, f"--model_dir={work}/esmm_model/"],
        "ESMM main path (--dma_scatter --map_workers=2 --packed_cache, parses and writes the cache)")
    cache = os.path.join(data, ".packed_cache")
    p = ESMM_WIDTH["multi_hot_pad"]
    metas = sorted(f for f in os.listdir(cache) if f.endswith(".meta.json"))
    check(metas == [f"tr.samples.txt.p{p}.meta.json", f"va.samples.txt.p{p}.meta.json"],
          f"ESMM: packed cache sidecars {metas}")
    snap = {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in os.listdir(cache)}
    log(f"ESMM packed cache: {len(snap)} files, "
        f"{sum(os.path.getsize(os.path.join(cache, f)) for f in snap) / 2**20:.0f} MiB")
    hit, _, rates["ESMM CLI, cache hit"] = esmm_cli(
        [*argv, f"--model_dir={work}/esmm_hit/"], "ESMM, second run (reads the cache)")
    now = {f: os.stat(os.path.join(cache, f)).st_mtime_ns for f in os.listdir(cache)}
    check(now == snap, "ESMM: the second run wrote to the packed cache; it should only read it")
    one, _, rates["ESMM CLI, cache hit, --map_workers=1"] = esmm_cli(
        [*argv, "--map_workers=1", f"--model_dir={work}/esmm_mw1/"],
        "ESMM, --map_workers=1 (reads the cache)")
    # each leg's input alone; the build on a hard link of the lines in a
    # directory of its own, whose cache does not exist yet
    link = os.path.join(work, "esmm_link")
    os.makedirs(link)
    os.link(tr, os.path.join(link, "tr.samples.txt"))
    for leg, extra in (("ESMM CLI, cache build", [f"--data_dir={link}"]), ("ESMM CLI, cache hit", []),
                       ("ESMM CLI, cache hit, --map_workers=1", ["--map_workers=1"])):
        rates[leg + " host"] = host_rate([*argv, *extra], EB)
        log(f"{leg}: the input alone {rates[leg + ' host']:.0f} examples/s")
    rel = abs(one["loss"] - hit["loss"]) / abs(hit["loss"])
    lt2, lt1 = last_train_loss(f"{work}/esmm_hit"), last_train_loss(f"{work}/esmm_mw1")
    rel_t = abs(lt1 - lt2) / abs(lt2)
    log(f"ESMM --map_workers=1 vs 2 on the same cached batches: eval loss {one['loss']:.7f} vs "
        f"{hit['loss']:.7f} (rel {rel:.2e}), last train loss {lt1:.7f} vs {lt2:.7f} "
        f"(rel {rel_t:.2e}); held at 1e-4")
    check(rel <= 1e-4 and rel_t <= 1e-4, "ESMM: --map_workers=1 and 2 end at other losses")
    return launches


def esmm_bare_step(dev, profile):
    """The bare ESMM --mh_coo sparse step on pre-mapped batches already on
    the card. profile: None, or the trace path ("" for none)."""
    cfg = Config(**ESMM_WIDTH)
    model = create_model(cfg)
    raw = esmm_batches(4, seed=3)
    chain = esmm_chain(model)
    t0 = time.perf_counter()
    mapped = [chain(b) for b in raw]
    host_ms = (time.perf_counter() - t0) / len(raw) * 1e3
    batches = [to_device(b, dev) for b in mapped]
    torch.cuda.reset_peak_memory_stats()
    params, mstate = model.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda x: x.to(dev), params)
    mstate = tree_map(lambda x: x.to(dev), mstate)
    tx = make_optimizer("Adam", cfg.learning_rate)
    sopt = SP.make_sparse_row_optimizer("Adam", cfg.learning_rate, fused_table=True,
                                        dma_scatter=cfg.dma_scatter)
    opt = SP.init_opt_state(model, tx, sopt, params)
    step = SP.build_sparse_train_step(model, tx, sopt, lookup=SR.make_expand_lookup())
    for i in range(5):  # the first call eager, then each batch's graph captured
        params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4])
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for i in range(n):
        params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    check(math.isfinite(float(loss)), f"bare ESMM step loss {float(loss)}")
    wmv = opt["sparse"]["emb"]["wmv"]
    log(f"bare step ESMM --mh_coo --dma_scatter: {ms:.3f} ms/step, {EB / ms * 1e3:.0f} examples/s "
        f"(peak mem {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, the {list(wmv.shape)} "
        f"w|m|v store {wmv.numel() * 4 / 2**20:.0f} MiB); host chain "
        f"(packer with combine + mapper) {host_ms:.1f} ms/batch")
    if profile is not None:
        trace = os.path.splitext(profile)[0] + "_esmm.json" if profile else ""
        profile_step("ESMM --mh_coo --dma_scatter", lambda i: step(params, opt, mstate, batches[i % 4]),
                     trace)
    return ms


def din_cli(argv, steps_min, label, rates=None):
    """One DIN CLI run with every launch counter zeroed just before and
    read just after; returns (result, launches). rates: where a training
    run puts its CLI examples/s under ``label``."""
    for mod in (SR, CP, SG, AU):
        mod.reset_launches()
    t0 = time.perf_counter()
    with StepClock() as clock:
        res = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in (SR.expand_rows, SR.accumulate_rows,
                                                CP.coo_pool_rows, CP.coo_accumulate_rows,
                                                SG.sorted_segsum, SG.sorted_expand,
                                                AU.att_unit_forward, AU.att_unit_backward)}
    steps = res.get("step", 0)
    per = {n: c / max(steps, 1) for n, c in launches.items()}
    rate = ""
    if rates is not None:
        rates[label] = clock.ex_per_s(EB)
        rates[label + " host"] = host_rate(argv, EB)
        rate = f"; CLI {rates[label]:.0f} examples/s; its input alone {rates[label + ' host']:.0f}"
    log(f"{label}: {steps} steps in {wall:.1f} s wall, launches {launches}, per step {per}{rate}")
    check(steps >= steps_min, f"{label} ran {steps} steps")
    check(math.isfinite(res["loss"]) and 0.0 <= res.get("auc", -1.0) <= 1.0, f"{label}: {res}")
    return res, launches


def din_main_path(dev, work, rates):
    """DIN training through the CLI on the ESMM path's Ali-CCP lines, then
    eval, then the --coo_sorted_bwd leg with --map_workers=2 (its width
    bucketer, packer and mapper on two threads, the sorted streams
    re-padded at the ordered output), whose eval and last train loss
    must match the same leg's with --map_workers=1 within 1e-4
    relative."""
    data = os.path.join(work, "esmm_data")
    argv = [f"--{k}={v}" for k, v in DIN_WIDTH.items()] + [
        "--num_epochs=1", "--log_steps=5", f"--data_dir={data}", "--dt_dir=smoke",
        "--eval_throttle_secs=0", f"--device={dev.type}", "--seed=2018",
    ]
    res, launches = din_cli(["--task_type=train", f"--model_dir={work}/din_model/", *argv],
                            ESMM_STEPS, "DIN main path", rates)
    steps = res["step"]
    for name in ("expand_rows", "accumulate_rows", "sorted_segsum", "sorted_expand"):
        check(launches[name] > 0, f"{name} was not launched on the DIN main path")
    # the two lookups (shared, COO) and the pool/select pair, twice each
    for name in ("expand_rows", "accumulate_rows", "sorted_segsum", "sorted_expand"):
        check(launches[name] == 2 * steps, f"DIN: {name} launched {launches[name]} times "
                                           f"in {steps} steps, expected 2 per step")
    # the fused attention unit: once each way a step, the forward also once
    # a batch of the run's closing eval
    check(launches["att_unit_backward"] == steps and launches["att_unit_forward"] > steps,
          f"DIN: the attention unit launched {launches['att_unit_forward']} forward, "
          f"{launches['att_unit_backward']} backward in {steps} steps, expected 1 and 1 a step "
          "(and the eval's forwards)")
    ev, elaunches = din_cli(["--task_type=eval", f"--model_dir={work}/din_model/", *argv], 0,
                            "DIN eval")
    check(elaunches["att_unit_forward"] >= 1 and elaunches["att_unit_backward"] == 0,
          f"DIN eval: the attention unit launched {elaunches['att_unit_forward']} forward, "
          f"{elaunches['att_unit_backward']} backward")
    check(abs(ev["loss"] - res["loss"]) <= 1e-4 * abs(res["loss"]),
          f"DIN eval {ev['loss']} differs from the train run's final eval {res['loss']}")
    sres, slaunches = din_cli(["--task_type=train", f"--model_dir={work}/din_sorted/",
                               "--coo_sorted_bwd=true", "--map_workers=2", *argv], 3,
                              "DIN --coo_sorted_bwd --map_workers=2", rates)
    ssteps = sres["step"]
    check(slaunches["sorted_segsum"] == 3 * ssteps,
          f"DIN --coo_sorted_bwd --map_workers=2: sorted_segsum launched {slaunches['sorted_segsum']} times "
          f"in {ssteps} steps, expected 3 per step")
    check(slaunches["accumulate_rows"] == ssteps,
          "DIN --coo_sorted_bwd: accumulate_rows should take only the shared lookup's backward")
    check(slaunches["expand_rows"] == 3 * ssteps,
          "DIN --coo_sorted_bwd: expand_rows should also gather the cotangent into sorted order")
    check(slaunches["att_unit_backward"] == ssteps,
          f"DIN --coo_sorted_bwd: att_unit_backward launched {slaunches['att_unit_backward']} "
          f"times in {ssteps} steps")
    one, _ = din_cli(["--task_type=train", f"--model_dir={work}/din_sorted_mw1/",
                      "--coo_sorted_bwd=true", "--map_workers=1", *argv], 3,
                     "DIN --coo_sorted_bwd --map_workers=1")
    rel = abs(one["loss"] - sres["loss"]) / abs(sres["loss"])
    lt2, lt1 = last_train_loss(f"{work}/din_sorted"), last_train_loss(f"{work}/din_sorted_mw1")
    rel_t = abs(lt1 - lt2) / abs(lt2)
    log(f"DIN --coo_sorted_bwd --map_workers=1 vs 2 on the same lines: eval loss {one['loss']:.7f} "
        f"vs {sres['loss']:.7f} (rel {rel:.2e}), last train loss {lt1:.7f} vs {lt2:.7f} "
        f"(rel {rel_t:.2e}); held at 1e-4")
    check(one["step"] == ssteps and rel <= 1e-4 and rel_t <= 1e-4,
          "DIN --coo_sorted_bwd: --map_workers=1 and 2 end at other losses")
    # K5 at n_out = Su: the one launch a step beyond the pool/select pair's
    launches["sorted_segsum (n_out=Su)"] = slaunches["sorted_segsum"] - 2 * ssteps
    # K2 by lookup: the --coo_sorted_bwd leg runs it only for the shared
    # lookup; the DIN run, once a step for each lookup
    launches["accumulate_rows (DIN shared lookup)"] = slaunches["accumulate_rows"]
    launches["accumulate_rows (DIN COO lookup)"] = launches["accumulate_rows"] - steps
    # the attention unit's row counts its training steps (one launch each
    # way, and one reduce, a step)
    launches["att_unit"] = launches["att_unit_backward"]
    return launches


def field_block_main_path(dev, work, rates):
    """DeepFM's dense step with --field_blocks through the CLI, on libsvm
    data in per-field blocks (the blocks --field_blocks names)."""
    data = os.path.join(work, "fb_data")
    os.makedirs(data)
    t0 = time.perf_counter()
    write_in_parts("libsvm", os.path.join(data, "tr.libsvm"), FB_STEPS * B, 3,
                   feature_size=WIDTH["feature_size"])
    write_synthetic_libsvm(os.path.join(data, "va.libsvm"), B, WIDTH["feature_size"], seed=4)
    log(f"field-blocks data: {FB_STEPS * B} train + {B} valid rows written in "
        f"{time.perf_counter() - t0:.1f} s")
    argv = [f"--{k}={v}" for k, v in FB_WIDTH.items()] + [
        "--task_type=train", "--num_epochs=1", "--log_steps=10", f"--data_dir={data}",
        f"--model_dir={work}/fb_model/", "--dt_dir=smoke", "--eval_throttle_secs=0",
        f"--device={dev.type}", "--seed=2018",
    ]
    FB.reset_launches()
    t0 = time.perf_counter()
    with StepClock() as clock:
        res = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"field_block_scatter": FB.field_block_scatter.launches}
    leg = "DeepFM dense --field_blocks CLI"
    rates[leg] = clock.ex_per_s(B)
    rates[leg + " host"] = host_rate(argv, B)
    log(f"DeepFM dense --field_blocks: {res['step']} steps in {wall:.1f} s wall, launches {launches}; "
        f"CLI {rates[leg]:.0f} examples/s; its input alone {rates[leg + ' host']:.0f}")
    check(res["step"] >= FB_STEPS, f"DeepFM --field_blocks ran {res['step']} steps")
    check(math.isfinite(res["loss"]) and 0.0 <= res["auc"] <= 1.0, f"DeepFM --field_blocks: {res}")
    check(launches["field_block_scatter"] == res["step"],
          f"field_block_scatter launched {launches['field_block_scatter']} times in {res['step']} "
          "steps, expected one table gradient a step")
    return launches


def zoo_main_path(dev, work):
    """The libsvm zoo through the CLI on the DeepFM main path's files (one
    epoch each): train, then --task_type=eval on its checkpoint, with the
    launch counters zeroed just before the training run and read just
    after it. The seven kernel models must launch K1 and K2 once a step,
    LR neither (plain lazy Adam); LR's run is repeated on the CPU, whose
    eval and last train loss must match the card's within 1e-4 relative.
    Returns {model: (launches, steps, CLI examples/s, peak bytes)}."""
    data = os.path.join(work, "data")
    out = {}
    t_all = time.perf_counter()
    for name in ZOO:
        width = zoo_width(name)
        b = width["batch_size"]
        argv = [f"--{k}={v}" for k, v in width.items()] + [
            "--num_epochs=1", "--log_steps=7", f"--data_dir={data}", f"--model_dir={work}/zoo_{name}/",
            "--dt_dir=smoke", "--eval_throttle_secs=0", f"--device={dev.type}", "--seed=2018",
        ]
        torch.cuda.reset_peak_memory_stats()
        SR.reset_launches()
        t0 = time.perf_counter()
        with StepClock() as clock:
            res = cli.main(["--task_type=train", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"expand_rows": SR.expand_rows.launches,
                    "accumulate_rows": SR.accumulate_rows.launches}
        peak = torch.cuda.max_memory_allocated()
        rate = clock.ex_per_s(b)
        steps = res["step"]
        ev = cli.main(["--task_type=eval", *argv])
        log(f"zoo {name} ({width['model']}, K={width.get('embedding_size', '-')}, B={b}"
            f"{', cut from 16384' if b != B else ''}): {steps} steps in {wall:.1f} s wall, loss "
            f"{res['loss']:.5f} auc {res['auc']:.5f}; eval loss {ev['loss']:.5f} auc {ev['auc']:.5f}; "
            f"launches {launches}; CLI {rate:.0f} examples/s; peak device memory "
            f"{peak / 2**30:.2f} GiB")
        check(steps == MAIN_STEPS * B // b, f"zoo {name} ran {steps} steps")
        for r in (res, ev):
            check(math.isfinite(r["loss"]) and 0.0 <= r["auc"] <= 1.0, f"zoo {name}: {r}")
        check(abs(ev["loss"] - res["loss"]) <= 1e-4 * abs(res["loss"]),
              f"zoo {name}: eval {ev['loss']} differs from the train run's final eval {res['loss']}")
        want = 0 if name == "LR" else steps
        for kname, c in launches.items():
            check(c == want, f"zoo {name}: {kname} launched {c} times in {steps} steps, "
                             f"expected {want}")
        if name == "LR":
            cpu = cli.main(["--task_type=train", *argv, f"--model_dir={work}/zoo_LR_cpu/",
                            "--device=cpu"])
            lt_card = last_train_loss(f"{work}/zoo_LR")
            lt_cpu = last_train_loss(f"{work}/zoo_LR_cpu")
            rel = max(abs(cpu["loss"] - res["loss"]) / abs(res["loss"]),
                      abs(lt_cpu - lt_card) / abs(lt_card))
            log(f"zoo LR card vs CPU CLI: eval loss {res['loss']:.7f} vs {cpu['loss']:.7f}, last "
                f"train loss {lt_card:.7f} vs {lt_cpu:.7f}: max rel diff {rel:.2e} (held at 1e-4)")
            check(rel <= 1e-4, f"zoo LR: card and CPU CLI losses differ by {rel}")
        out[name] = (launches, steps, rate, peak)
    log(f"zoo phase (train, eval, LR on the CPU): {time.perf_counter() - t_all:.1f} s")
    return out


def zoo_bare_step(dev, name, profile):
    """The bare step of one zoo model on pre-mapped batches already on the
    card, dropout on (a generator on the card), as the CLI runs it:
    3 warm-up steps, then 10 timed. profile: None, or the trace path (""
    for none). Returns (ms, peak bytes)."""
    cfg = Config(**zoo_width(name))
    model = create_model(cfg)
    b = cfg.batch_size
    mapper = SparseBatchMapper(model.sparse_slots())
    batches = [to_device(mapper(dict(x)), dev) for x in zipf_batches(4, seed=3, batch=b)]
    torch.cuda.reset_peak_memory_stats()
    params, mstate = model.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda x: x.to(dev), params)
    mstate = tree_map(lambda x: x.to(dev), mstate)
    tx = make_optimizer("Adam", cfg.learning_rate)
    sopt = SP.make_sparse_row_optimizer("Adam", cfg.learning_rate, fused_table=cfg.fused_table)
    opt = SP.init_opt_state(model, tx, sopt, params)
    step = SP.build_sparse_train_step(model, tx, sopt, lookup=SR.make_expand_lookup()
                                      if cfg.pallas_expand else None)
    gen = torch.Generator(device=dev).manual_seed(1)
    for i in range(3):
        params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4], gen)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for i in range(n):
        params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4], gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(float(loss)), f"bare zoo {name} step loss {float(loss)}")
    log(f"bare step zoo {name} (B={b}): {ms:.3f} ms/step, {b / ms * 1e3:.0f} examples/s (peak mem "
        f"{peak / 2**30:.2f} GiB)")
    if profile is not None:
        trace = os.path.splitext(profile)[0] + f"_zoo_{name}.json" if profile else ""
        profile_step(f"zoo {name}", lambda i: step(params, opt, mstate, batches[i % 4], gen), trace)
    del params, opt, mstate, batches
    torch.cuda.empty_cache()
    return ms, peak


def lazy_optimizers_main_path(dev, work, rates):
    """DeepFM at the main path's width on its files (one epoch, 21 steps)
    under each of the other optimizers' lazy row forms, through the CLI:
    --sparse_table_update --pallas_expand without the fused store, so K1
    and K2 run on the [S, 17] rows of the plain table store. Each run:
    launch counters zeroed just before and read just after, K1 and K2
    once a step, finite loss, then --task_type=eval with AUC in [0, 1].
    Returns {optimizer: (launches, steps)}; the CLI examples/s go into
    rates."""
    data = os.path.join(work, "data")
    out = {}
    t_all = time.perf_counter()
    for opt in LAZY_OPTS:
        argv = [f"--{k}={v}" for k, v in dict(LAZY_WIDTH, optimizer=opt).items()] + [
            "--num_epochs=1", "--log_steps=7", f"--data_dir={data}",
            f"--model_dir={work}/lazy_{opt}/", "--dt_dir=smoke", "--eval_throttle_secs=0",
            f"--device={dev.type}", "--seed=2018"]
        SR.reset_launches()
        t0 = time.perf_counter()
        with StepClock() as clock:
            res = cli.main(["--task_type=train", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"expand_rows": SR.expand_rows.launches,
                    "accumulate_rows": SR.accumulate_rows.launches}
        steps = res["step"]
        rates[f"DeepFM lazy {opt} CLI"] = clock.ex_per_s(B)
        ev = cli.main(["--task_type=eval", *argv])
        log(f"lazy {opt} (DeepFM, unfused store): {steps} steps in {wall:.1f} s wall, loss "
            f"{res['loss']:.5f} auc {res['auc']:.5f}; eval loss {ev['loss']:.5f} auc "
            f"{ev['auc']:.5f}; launches {launches}; CLI {rates[f'DeepFM lazy {opt} CLI']:.0f} "
            "examples/s")
        check(steps == MAIN_STEPS, f"lazy {opt} ran {steps} steps")
        for r in (res, ev):
            check(math.isfinite(r["loss"]) and 0.0 <= r["auc"] <= 1.0, f"lazy {opt}: {r}")
        for kname, c in launches.items():
            check(c == steps, f"lazy {opt}: {kname} launched {c} times in {steps} steps, "
                              "expected one a step")
        out[opt] = (launches, steps)
    log(f"lazy optimizers phase (train, eval): {time.perf_counter() - t_all:.1f} s")
    return out


def lazy_bare_steps(dev, profile):
    """The bare lazy step of each other optimizer on the DeepFM main path's
    width, on pre-mapped Zipf(1.2) batches already on the card (K1/K2 on
    the unfused store): 3 warm-up steps, then 30 timed. Returns
    {optimizer: ms}. profile: None, or the trace path ("" for none); the
    Adagrad step is profiled."""
    raw = zipf_batches(4)
    out = {}
    for opt in LAZY_OPTS:
        cfg = Config(**dict(LAZY_WIDTH, optimizer=opt))
        model = create_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params, mstate = model.init(torch.Generator().manual_seed(0))
        params = tree_map(lambda x: x.to(dev), params)
        mstate = tree_map(lambda x: x.to(dev), mstate)
        tx = make_optimizer(opt, cfg.learning_rate)
        sopt = SP.make_sparse_row_optimizer(opt, cfg.learning_rate)
        opt_state = SP.init_opt_state(model, tx, sopt, params)
        step = SP.build_sparse_train_step(model, tx, sopt, lookup=SR.make_expand_lookup())
        mapper = SparseBatchMapper(model.sparse_slots())
        batches = [to_device(mapper(dict(b)), dev) for b in raw]
        for i in range(5):  # the first call eager, then each batch's graph captured
            params, opt_state, mstate, loss = step(params, opt_state, mstate, batches[i % 4])
        torch.cuda.synchronize()
        n = 30
        t0 = time.perf_counter()
        for i in range(n):
            params, opt_state, mstate, loss = step(params, opt_state, mstate, batches[i % 4])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        check(math.isfinite(float(loss)), f"bare lazy {opt} step loss {float(loss)}")
        out[opt] = ms
        log(f"bare step lazy {opt} (DeepFM, unfused store): {ms:.3f} ms/step, "
            f"{B / ms * 1e3:.0f} examples/s (peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB)")
        if profile is not None and opt == "Adagrad":
            trace = os.path.splitext(profile)[0] + "_adagrad.json" if profile else ""
            profile_step("DeepFM lazy Adagrad",
                         lambda i: step(params, opt_state, mstate, batches[i % 4]), trace)
        del params, opt_state, mstate, batches
    torch.cuda.empty_cache()
    return out


def wd_argv(dev, work, model_dir, **over):
    return [f"--{k}={v}" for k, v in dict(WD_WIDTH, **over).items()] + [
        "--log_steps=5", f"--data_dir={work}/wd_data", f"--model_dir={work}/{model_dir}/",
        "--dt_dir=smoke", "--eval_throttle_secs=0", f"--device={dev.type}", "--seed=2018"]


def write_wd_data(data):
    """The Wide&Deep CSV files, one writer process a file, all started
    together (the writer draws a scalar at a time, ~70 us a line): train
    in WD_FILES parts, one batch of va lines, 2,048 te lines."""
    os.makedirs(data)
    code = ("import sys; from tf_repos_tpu_torch.data.synthetic import write_synthetic_csv as w; "
            "w(sys.argv[1], int(sys.argv[2]), cat_buckets=int(sys.argv[3]), seed=int(sys.argv[4]))")
    jobs = [(f"tr.part{i}.csv", WD_TR_ROWS // WD_FILES, 31 + i) for i in range(WD_FILES)]
    jobs += [("va.csv", B, 41), ("te.csv", 2048, 42)]
    procs = [subprocess.Popen([sys.executable, "-c", code, os.path.join(data, name), str(rows),
                               str(WD_BUCKETS), str(seed)], cwd=HERE) for name, rows, seed in jobs]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rcs == [0] * len(jobs), f"the csv writers exited {rcs}")


def wd_sidecars(data):
    d = os.path.join(data, ".packed_cache")
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in os.listdir(d)} if os.path.isdir(d) else {}


def wide_deep_main_path(dev, work, rates):
    """Wide&Deep (wdl) at its published configuration on the port's CSV
    lines, through the CLI: 20 steps (two epochs of 10) on the streaming
    reader, then --task_type=eval; the same with --packed_cache=true
    twice (the run that parses and writes the csv40 cache, and one that
    only reads it, no sidecar rewritten), whose evals and last train
    losses must agree within 1e-4 relative (same batches); then "wide"
    (wdl) for 10 steps and its eval. The dense step has no kernel: K1 and
    K2 must not launch while training. Each run's CLI examples/s, the
    input alone for the streaming and the cached reader, the Python parse
    of one batch, and the peak device memory go into rates."""
    data = os.path.join(work, "wd_data")
    t0 = time.perf_counter()
    write_wd_data(data)
    log(f"Wide&Deep data: {WD_TR_ROWS} train lines in {WD_FILES} files, {B} valid and 2048 test "
        f"lines written in {time.perf_counter() - t0:.1f} s ({WD_FILES + 2} writer processes)")
    with open(os.path.join(data, "tr.part0.csv"), "rb") as f:
        lines = [next(f) for _ in range(WD_TR_ROWS // WD_FILES)][:B]
    t_parse, _ = best_s(lambda: parse_csv_lines(lines), 1)
    rates["wide_n_deep python parse ms"] = t_parse * 1e3
    log(f"host input, Wide&Deep, per {len(lines)}-line batch: Python csv parse "
        f"{t_parse * 1e3:.1f} ms (the only csv parser, in both packages)")
    legs = [("wide_n_deep CLI", "wd_model", {}),
            ("wide_n_deep CLI, cache build", "wd_cache_build", {"packed_cache": "true"}),
            ("wide_n_deep CLI, cache hit", "wd_cache_hit", {"packed_cache": "true"}),
            ("wide CLI", "wd_wide", {"model": "wide"})]
    out = {}
    for leg, model_dir, over in legs:
        epochs = 1 if over.get("model") == "wide" else 2
        argv = wd_argv(dev, work, model_dir, **over) + [f"--num_epochs={epochs}"]
        before = wd_sidecars(data)
        torch.cuda.reset_peak_memory_stats()
        SR.reset_launches()
        t0 = time.perf_counter()
        with StepClock() as clock:
            res = cli.main(["--task_type=train", *argv])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = SR.expand_rows.launches + SR.accumulate_rows.launches
        rates[leg] = clock.ex_per_s(B)
        peak = torch.cuda.max_memory_allocated()
        ev = cli.main(["--task_type=eval", *argv])
        after = wd_sidecars(data)
        log(f"{leg}: {res['step']} steps in {wall:.1f} s wall, loss {res['loss']:.5f} auc "
            f"{res['auc']:.5f}; eval loss {ev['loss']:.5f} auc {ev['auc']:.5f}; CLI "
            f"{rates[leg]:.0f} examples/s; peak device memory {peak / 2**30:.2f} GiB; K1/K2 "
            f"launches {launches}; cache sidecars {len(before)} before, {len(after)} after")
        check(res["step"] == 10 * epochs, f"{leg} ran {res['step']} steps")
        for r in (res, ev):
            check(math.isfinite(r["loss"]) and 0.0 <= r["auc"] <= 1.0, f"{leg}: {r}")
        check(abs(ev["loss"] - res["loss"]) <= 1e-4 * abs(res["loss"]),
              f"{leg}: eval {ev['loss']} differs from the train run's final eval {res['loss']}")
        check(launches == 0, f"{leg}: the dense step launched K1/K2 {launches} times")
        if leg.endswith("cache build"):
            # cont, cat, label and mask arrays and a meta file for each
            # train file and the va file (the final eval reads it cached)
            check(not before and len(after) == 5 * (WD_FILES + 1),
                  f"{leg}: cache sidecars {sorted(after)}")
        if leg.endswith("cache hit"):
            check(after == before, f"{leg}: the cache was rewritten")
        out[leg] = (res, ev, peak, model_dir)
        if leg in ("wide_n_deep CLI", "wide_n_deep CLI, cache hit"):
            rates[leg + " host"] = host_rate(argv, B)
            log(f"{leg}: the input alone {rates[leg + ' host']:.0f} examples/s")
    (rb, eb, _, db), (rh, eh, _, dh) = out["wide_n_deep CLI, cache build"], out[
        "wide_n_deep CLI, cache hit"]
    lb, lh = last_train_loss(f"{work}/{db}"), last_train_loss(f"{work}/{dh}")
    rel = max(abs(eb["loss"] - eh["loss"]) / abs(eb["loss"]), abs(lb - lh) / abs(lb))
    log(f"Wide&Deep cache build vs cache hit: eval loss {eb['loss']:.7f} vs {eh['loss']:.7f}, last "
        f"train loss {lb:.7f} vs {lh:.7f}: max rel diff {rel:.2e} (held at 1e-4)")
    check(rel <= 1e-4, f"Wide&Deep: the cache build and hit runs differ by {rel}")
    return {leg: v[2] for leg, v in out.items()}


def wd_bare_step(dev, profile, model="wide_n_deep"):
    """The bare dense Wide&Deep step (wdl) on parsed CSV batches already on
    the card, as the CLI runs it: 3 warm-up steps, then 20 timed. Returns
    (ms, peak bytes)."""
    cfg = Config(**dict(WD_WIDTH, model=model))
    m = create_model(cfg)
    rng = np.random.default_rng(12)
    lines = [",".join([str(int(rng.random() < 0.5))] + [f"{x:.4f}" for x in rng.random(13)]
                      + [str(c) for c in rng.integers(0, WD_BUCKETS, 26)]).encode()
             for _ in range(4 * B)]
    batches = [to_device(parse_csv_lines(lines[i * B:(i + 1) * B]), dev) for i in range(4)]
    torch.cuda.reset_peak_memory_stats()
    params, mstate = m.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda x: x.to(dev), params)
    mstate = tree_map(lambda x: x.to(dev), mstate)
    tx = make_optimizer("wdl", cfg.learning_rate, m.model_type)
    opt = tx.init(params)
    step = L.build_train_step(m, tx)
    for i in range(3):
        params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4])
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for i in range(n):
        params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(float(loss)), f"bare {model} step loss {float(loss)}")
    log(f"bare step {model} (wdl, dense, B={B}): {ms:.3f} ms/step, {B / ms * 1e3:.0f} examples/s "
        f"(peak mem {peak / 2**30:.2f} GiB)")
    if profile is not None and model == "wide_n_deep":
        trace = os.path.splitext(profile)[0] + "_wd.json" if profile else ""
        profile_step("Wide&Deep dense", lambda i: step(params, opt, mstate, batches[i % 4]), trace)
    del params, opt, mstate, batches
    torch.cuda.empty_cache()
    return ms, peak


# ------------------------------------------------------------- phase 4b
SERVE_BUCKETS = (1, 8, 64, 512)
LAT_CALLS = 50  # scorer calls a bucket, and HTTP requests a size, for the latency


def pcts(xs):
    return float(np.percentile(xs, 50)), float(np.percentile(xs, 99))


def http_json(port, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def json_instances(inst):
    return [{k: np.asarray(v).tolist() for k, v in i.items()} for i in inst]


def grpc_web_predict(port, inst, model):
    """One grpc-web framed PredictRequest to the HTTP server; the decoded
    outputs and the trailer."""
    msg = PP.encode_predict_request({k: np.stack([np.asarray(i[k]) for i in inst]) for k in inst[0]},
                                    model, "serving_default")
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/tensorflow.serving.PredictionService/Predict",
        data=b"\x00" + len(msg).to_bytes(4, "big") + msg,
        headers={"Content-Type": "application/grpc-web+proto"})
    with urllib.request.urlopen(req, timeout=60) as r:
        body = r.read()
    check(len(body) > 5 and body[0] == 0, f"grpc-web reply without a DATA frame: {body[-200:]!r}")
    n = int.from_bytes(body[1:5], "big")
    return PP.decode_predict_response(body[5 : 5 + n])[0], body[5 + n :]


def held_rel(name, got, want, rtol):
    """|got - want| <= rtol * |want| + 1e-6 element-wise; returns the max
    abs difference."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    check(got.shape == want.shape and bool((d <= rtol * np.abs(want) + 1e-6).all()),
          f"{name}: max abs diff {float(d.max()) if d.size else 'shape'} (rtol {rtol})")
    return float(d.max())


def device_ops(fn) -> int:
    """The device operations (kernels, copies, fills) of one call of fn,
    from torch.profiler, as profile_step counts them. fn always launches,
    so a trace with no device operation at all is one the profiler
    missed (seen once in a run of this script, where the same count read
    1 in two other runs): it is taken again, at most three times in all,
    and each miss is printed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = 0
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0)
        if n:
            break
        log(f"device_ops: the profiler traced no device operation (attempt {attempt + 1} of 3)")
    return n


def deepfm_serving_ids(feat_ids, dev):
    """The ids DeepFM's serving lookup receives for a [B, 39] batch: the
    26 dynamic fields, a view of the int32 batch on the card."""
    return torch.from_numpy(np.asarray(feat_ids, np.int32)).to(dev)[:, STATIC:]


ALICCP_GATHER_KEYS = ("feat_ids", "u_catids", "u_shopids", "u_brandids", "u_intids", "a_catids",
                      "a_shopids", "a_brandids", "a_intids")


def aliccp_serving_ids(batch, dev):
    """The ids of ESMM's and DIN's one padded serving gather: the common,
    user, scalar ad and a_int ids of each row, int32 [B, 2574] at pad 512."""
    n = batch["feat_ids"].shape[0]
    return torch.from_numpy(np.concatenate(
        [np.asarray(batch[k], np.int32).reshape(n, -1) for k in ALICCP_GATHER_KEYS], axis=1)).to(dev)


def old_serving_gather(table, ids):
    """The serving gather before K1 took JAX's id rule: normalize_ids on
    the card (after a copy of a non-contiguous view), then K1."""
    flat = SR.normalize_ids(ids.reshape(-1), table.shape[0]).to(torch.int32).contiguous()
    return SR.expand_rows(table, flat).reshape(tuple(ids.shape) + (table.shape[-1],))


def serving_k1(label, table, ids, count_ops=True):
    """K1 at a scorer's gather over the whole table, ``ids`` as the
    model's lookup receives them: the one-launch serving entry
    (expand_rows_clamped) bit-exact against the plain gather on
    normalised ids, in f32 and bf16, also with -1, V, 2**31-1 and -2**31
    written into the ids; the unclamped entry likewise on the normalised
    ids. CUDA-event times of the kernel alone (on the normalised ids),
    of the whole gather as the scorer ran it before (normalize_ids + K1)
    and as it runs it now (the one launch), of the plain version,
    index_select and an empty launch; the device operations of both
    gathers (torch.profiler; unless count_ops is false); and the bound:
    the ids, the distinct rows they read and the output, each moved
    once."""
    v, c = table.shape
    idx = SR.normalize_ids(ids.reshape(-1), v).to(torch.int32).contiguous()
    # the same ids in the same layout (a view keeps its row stride), with
    # JAX's edge cases in row 0
    wild = torch.zeros((ids.shape[0], ids.stride(0)), dtype=ids.dtype,
                       device=ids.device)[:, :ids.shape[1]]
    wild.copy_(ids)
    wild[0, :4] = torch.tensor([-1, v, 2**31 - 1, -(2**31)], dtype=ids.dtype)
    for tb in (table, table.to(torch.bfloat16)):
        check(torch.equal(SR.expand_rows(tb, idx), SR.expand_rows_plain(tb, idx)),
              f"expand_rows (serving, {label}, {tb.dtype}) differs from table[idx]")
        for i2 in (ids, wild):
            want = SR.expand_rows_plain(tb, SR.normalize_ids(i2.reshape(-1), v))
            check(torch.equal(SR.expand_rows_clamped(tb, i2).reshape(want.shape), want),
                  f"expand_rows_clamped (serving, {label}, {tb.dtype}) differs from the plain "
                  "gather on normalised ids")
    check(torch.equal(SR.expand_rows_clamped(table, wild).reshape(-1, c)[:4],
                      table[torch.tensor([v - 1, v - 1, v - 1, 0], device=table.device)]),
          f"the serving entry ({label}) reads other rows than JAX's gather for -1, V, 2**31-1, "
          "-2**31")
    n, rows = idx.shape[0], int(torch.unique(idx).numel())
    nbytes = n * ids.element_size() + rows * c * 4 + n * c * 4
    t_kernel = cuda_ms(lambda: SR.expand_rows(table, idx))
    t_before = cuda_ms(lambda: old_serving_gather(table, ids))
    t = (cuda_ms(lambda: SR.expand_rows_clamped(table, ids)),
         cuda_ms(lambda: SR.expand_rows_plain(table, SR.normalize_ids(ids.reshape(-1), v))),
         cuda_ms(lambda: torch.index_select(table, 0, idx)))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    # an empty launch in the same harness: a kernel that spins 0 cycles,
    # the floor under any one-launch gather
    empty = cuda_ms(lambda: torch.cuda._sleep(0))
    ops = "not counted"
    if count_ops:
        ops_before = device_ops(lambda: old_serving_gather(table, ids))
        ops_after = device_ops(lambda: SR.expand_rows_clamped(table, ids))
        check(ops_after == 1,
              f"the serving gather ({label}) made {ops_after} device operations, not 1")
        ops = f"{ops_before} → {ops_after}"
    log(f"kernel expand_rows (serving, whole table, {label}): table [{v}, {c}] f32, ids "
        f"{tuple(ids.shape)} {ids.dtype} strides {ids.stride()}, N={n}, {rows} distinct rows: "
        f"bit-exact (f32, bf16, wild ids)  kernel alone {t_kernel:.4f} ms; the gather before "
        f"(normalize_ids + K1) {t_before:.4f} ms, now (one launch) {t[0]:.4f} ms; device "
        f"operations {ops}; plain {t[1]:.4f} ms  library (index_select) "
        f"{t[2]:.4f} ms  bound {bound:.5f} ms (bytes: {nbytes / 1e6:.2f} MB); an empty launch "
        f"(torch.cuda._sleep(0)) in the same harness {empty:.4f} ms")
    return t, bound


def deepfm_serving(dev, work):
    """DeepFM at the bench width from the main path's checkpoint: export and
    infer through the CLI, then the HTTP server on the card (REST at
    every bucket size, the columnar form, grpc-web, ids outside [0, V)),
    hot reload, and the per-bucket latency."""
    data = os.path.join(work, "data")
    v = WIDTH["feature_size"]
    argv = [f"--{k}={val}" for k, val in WIDTH.items()] + [
        f"--data_dir={data}", f"--model_dir={work}/model/", "--dt_dir=smoke",
        f"--device={dev.type}", "--seed=2018"]
    t0 = time.perf_counter()
    vdir = cli.main(["--task_type=export", *argv])
    servable = os.path.dirname(vdir)
    te = os.path.join(data, "te.libsvm")
    write_synthetic_libsvm(te, B, v, seed=5, zipf_a=1.2)
    SR.reset_launches()
    pred_path = cli.main(["--task_type=infer", *argv])
    infer_launches = SR.expand_rows.launches
    preds = np.loadtxt(pred_path)
    log(f"serving DeepFM: export to {vdir} and infer of {preds.shape[0]} te rows in "
        f"{time.perf_counter() - t0:.1f} s; infer launched expand_rows {infer_launches} times")
    check(preds.shape == (B,) and bool(np.isfinite(preds).all()), f"pred.txt shape {preds.shape}")
    check(infer_launches >= 1, "expand_rows was not launched by task_type=infer")
    tb = next(iter(LibsvmDataset([te], field_size=WIDTH["field_size"], batch_size=B)))
    rows = [{"feat_ids": tb["feat_ids"][i], "feat_vals": tb["feat_vals"][i]} for i in range(B)]

    srv = PredictionServer(servable, port=0, grpc_port=-1, reload_secs=0, device=dev.type)
    srv.start()
    try:
        card = srv.scorer
        cpu = Scorer(servable, warmup=False, device="cpu")
        url = "/v1/models/DeepFM:predict"
        wild = [dict(rows[0], feat_ids=rows[0]["feat_ids"].copy()) for _ in range(3)]
        for i, bad in enumerate((-1, v, 2**31 - 1)):
            wild[i]["feat_ids"][STATIC + i::4] = bad
        sent = [(f"REST {n}", rows[:n]) for n in SERVE_BUCKETS] + [
            ("REST columnar 8", rows[8:16]), ("grpc-web 8", rows[16:24]),
            ("REST ids -1, V, 2**31-1", wild)]
        # the server's run: launch counts zeroed just before, read just after
        n0 = len(srv.batcher.timings)
        SR.reset_launches()
        replies = {}
        for name, inst in sent:
            if name.startswith("grpc-web"):
                out, trailer = grpc_web_predict(srv.port, inst, "DeepFM")
                check(b"grpc-status: 0" in trailer, f"grpc-web trailer {trailer!r}")
                replies[name] = out["prob"]
            elif "columnar" in name:
                cols = {k: [np.asarray(i[k]).tolist() for i in inst] for k in inst[0]}
                replies[name] = np.asarray(http_json(srv.port, url, {"inputs": cols})["predictions"])
            else:
                replies[name] = np.asarray(http_json(srv.port, url, {"instances": json_instances(inst)})
                                           ["predictions"])
        launches = SR.expand_rows.launches
        batches = len(srv.batcher.timings) - n0
        log(f"serving DeepFM server: {len(sent)} requests in {batches} scored batches, "
            f"expand_rows launched {launches} times")
        check(launches >= batches >= 1, f"expand_rows launched {launches} times for {batches} "
                                        "scored batches: K1 is not on the serving path")
        worst_cpu = 0.0
        for name, inst in sent:
            want = card.score(inst)["prob"]
            check(np.array_equal(np.asarray(replies[name], np.float32), want),
                  f"{name}: the server's reply differs from Scorer.score on the card")
            worst_cpu = max(worst_cpu, held_rel(f"{name} card vs CPU scorer", want,
                                                cpu.score(inst)["prob"], 2e-2))
        log(f"serving DeepFM replies: every reply equals Scorer.score on the card; card vs CPU "
            f"scorer max abs diff {worst_cpu:.3e} (bf16 towers, held at 2e-2)")
        e_inf = held_rel("pred.txt vs the card scorer", preds, card.score(rows)["prob"], 2e-2)
        log(f"serving DeepFM infer: pred.txt ({B} rows, batch {B}) vs the card scorer (buckets of "
            f"512) max abs diff {e_inf:.3e} (bf16 towers at another batch size, held at 2e-2)")
        stats = http_json(srv.port, "/stats")
        check(stats.get("count", 0) >= batches, f"/stats {stats}")

        # hot reload: a second export, then maybe_reload switches the version
        v0 = card.version
        while int(time.time()) <= int(v0):
            time.sleep(0.05)
        cli.main(["--task_type=export", *argv])
        check(card.maybe_reload() and card.version != v0, "hot reload did not switch the version")
        resp = http_json(srv.port, url, {"instances": json_instances(rows[:8])})
        check(resp["model_version"] == card.version and
              np.array_equal(np.asarray(resp["predictions"], np.float32), replies["REST 8"]),
              "the reloaded servable answers another version or other values")
        log(f"serving DeepFM hot reload: version {v0} -> {card.version}, same answers")

        # latency: LAT_CALLS scorer calls per bucket, HTTP round trips of one client
        lat = {}
        for b in SERVE_BUCKETS:
            rec = []
            for _ in range(LAT_CALLS):
                t1 = time.perf_counter()
                card.score(rows[:b])
                rec.append((card.last_timing["batchify_ms"], card.last_timing["device_ms"],
                            (time.perf_counter() - t1) * 1e3))
            r = np.asarray(rec)
            lat[b] = [pcts(r[:, j]) for j in range(3)]
            log(f"serving latency DeepFM bucket {b} ({LAT_CALLS} scorer calls): batchify p50 "
                f"{lat[b][0][0]:.3f} p99 {lat[b][0][1]:.3f} ms; device p50 {lat[b][1][0]:.3f} p99 "
                f"{lat[b][1][1]:.3f} ms; score p50 {lat[b][2][0]:.3f} p99 {lat[b][2][1]:.3f} ms")
        for n in (1, 64):
            # the same request through the micro-batcher alone (its
            # max_wait_ms window and the scorer), then over HTTP
            body, sub, ts = {"instances": json_instances(rows[:n])}, [], []
            for _ in range(LAT_CALLS):
                t1 = time.perf_counter()
                srv.batcher.submit(rows[:n])
                sub.append((time.perf_counter() - t1) * 1e3)
            for _ in range(LAT_CALLS):
                t1 = time.perf_counter()
                http_json(srv.port, url, body)
                ts.append((time.perf_counter() - t1) * 1e3)
            score = [r["score_ms"] for r in srv.batcher.timings[-LAT_CALLS:]]
            (p50, p99), (s50, s99), (b50, b99) = pcts(ts), pcts(sub), pcts(score)
            log(f"serving latency DeepFM HTTP round trip, {n} instance(s), one sequential client "
                f"({LAT_CALLS} requests): p50 {p50:.3f} p99 {p99:.3f} ms; the server's score_ms "
                f"of those batches p50 {b50:.3f} p99 {b99:.3f} ms; the same request through the "
                f"micro-batcher alone (no HTTP) p50 {s50:.3f} p99 {s99:.3f} ms")

        # the device operations of one bucket-512 score (host-to-device
        # copies, the forward, the copy back)
        card.score(rows[:512])
        n_ops = device_ops(lambda: card.score(rows[:512]))
        log(f"serving DeepFM: one bucket-512 Scorer.score makes {n_ops} device operations "
            "(torch.profiler)")
        # K1 at the bucket-512 gather: the 26 dynamic fields of 512 rows
        ids = deepfm_serving_ids(np.stack([r["feat_ids"] for r in rows[:512]]), dev)
        t, bound = serving_k1("DeepFM bucket 512", card.params["fm_wv"], ids)
    finally:
        srv.stop()
    return t, bound, launches


def aliccp_serving(dev, work, label, width, model_dir):
    """ESMM or DIN at the published Ali-CCP point from its CLI model_dir:
    export, then one bucket of 64 va lines through the card's scorer,
    held to a CPU scorer over the same servable."""
    argv = [f"--{k}={val}" for k, val in width.items()] + [
        f"--data_dir={work}/esmm_data", f"--model_dir={work}/{model_dir}/", "--dt_dir=smoke",
        f"--device={dev.type}", "--seed=2018"]
    t0 = time.perf_counter()
    servable = os.path.dirname(cli.main(["--task_type=export", *argv]))
    t_export = time.perf_counter() - t0
    card = Scorer(servable, batch_buckets=(64,), device=dev.type)
    cpu = Scorer(servable, batch_buckets=(64,), warmup=False, device="cpu")
    with open(os.path.join(work, "esmm_data", "va.samples.txt"), "rb") as f:
        lines = [next(f) for _ in range(64)]
    batch = parse_aliccp_lines(lines, width["multi_hot_pad"])
    inst = [{k: batch[k][i] for k in card.signature["inputs"]} for i in range(64)]
    SR.reset_launches()
    got = card.score(inst)
    launches = SR.expand_rows.launches
    check(launches >= 1, f"{label}: expand_rows was not launched by the scorer")
    want = cpu.score(inst)
    err = max(held_rel(f"{label} card vs CPU scorer {k}", got[k], want[k], 2e-2) for k in want)
    log(f"serving {label}: export in {t_export:.1f} s; one bucket of 64 va lines, outputs "
        f"{sorted(got)}, expand_rows launched {launches} time(s); card vs CPU scorer max abs "
        f"diff {err:.3e} (bf16 towers, held at 2e-2); card device_ms "
        f"{card.last_timing['device_ms']:.3f}")
    # the model's one padded gather: the common, user, scalar ad and a_int ids
    t, bound = serving_k1(f"{label} bucket 64", card.params["emb"], aliccp_serving_ids(batch, dev))
    del card, cpu
    torch.cuda.empty_cache()
    return t, bound, launches


def zoo_serving(dev, work):
    """IPNN (a fused [V, 1+K] table) and LR (a 1-D [V] table, gathered as
    its [V, 1] view) from their zoo checkpoints: exported through the
    CLI, one bucket of 64 va lines scored by the card's and a CPU scorer,
    each gather one K1 launch. Returns LR's serving K1 entry (times,
    bound, launches)."""
    with open(os.path.join(work, "data", "va.libsvm"), "rb") as f:
        lines = [next(f) for _ in range(64)]
    ids, vals, _ = parse_libsvm_lines(lines, WIDTH["field_size"])
    inst = [{"feat_ids": ids[i], "feat_vals": vals[i]} for i in range(64)]
    res = None
    for name in ("IPNN", "LR"):
        argv = [f"--{k}={v}" for k, v in zoo_width(name).items()] + [
            f"--data_dir={work}/data", f"--model_dir={work}/zoo_{name}/", "--dt_dir=smoke",
            f"--device={dev.type}", "--seed=2018"]
        servable = os.path.dirname(cli.main(["--task_type=export", *argv]))
        card = Scorer(servable, batch_buckets=(64,), device=dev.type)
        cpu = Scorer(servable, batch_buckets=(64,), warmup=False, device="cpu")
        SR.reset_launches()
        got = card.score(inst)
        launches = SR.expand_rows.launches
        err = held_rel(f"zoo {name} card vs CPU scorer", got["prob"], cpu.score(inst)["prob"], 2e-2)
        log(f"serving zoo {name}: one bucket of 64 va lines, expand_rows launched {launches} "
            f"time(s); card vs CPU scorer max abs diff {err:.3e} (bf16 towers, held at 2e-2)")
        check(launches == 1, f"zoo {name}: the scorer's gather launched K1 {launches} times, not 1")
        if name == "LR":
            t, bound = serving_k1("LR bucket 64", card.params["w"][:, None],
                                  torch.from_numpy(ids).to(dev))
            res = (t, bound, launches)
        del card, cpu
    return res


def wd_serving(dev, work):
    """Wide&Deep from its CLI checkpoint: export and infer (the 2,048 te
    lines, one batch) through the CLI; one bucket of 64 va lines scored
    by the card's scorer (K1 twice: emb and wide_cat's [V, 1] view) and
    held to a CPU scorer within 2e-2 (bf16 towers); one REST request of
    cont/cat instances through PredictionServer on the card, equal to
    the card scorer's scores; K1 at both gathers as serving_k1 checks and
    times it. Returns {entry: (times, bound, launches)}."""
    argv = wd_argv(dev, work, "wd_model")
    servable = os.path.dirname(cli.main(["--task_type=export", *argv]))
    SR.reset_launches()
    pred_path = cli.main(["--task_type=infer", *argv])
    infer_launches = SR.expand_rows.launches
    preds = np.loadtxt(pred_path)
    check(preds.shape == (2048,) and bool(((preds >= 0) & (preds <= 1)).all()),
          f"Wide&Deep pred.txt: shape {preds.shape}")
    check(infer_launches == 2 * -(-2048 // B),
          f"Wide&Deep infer launched K1 {infer_launches} times, not 2 a batch")
    with open(os.path.join(work, "wd_data", "va.csv"), "rb") as f:
        lines = [next(f) for _ in range(64)]
    batch = parse_csv_lines(lines)
    inst = [{"cont": batch["cont"][i], "cat": batch["cat"][i]} for i in range(64)]
    card = Scorer(servable, batch_buckets=(64,), device=dev.type)
    cpu = Scorer(servable, batch_buckets=(64,), warmup=False, device="cpu")
    SR.reset_launches()
    got = card.score(inst)["prob"]
    launches = SR.expand_rows.launches
    err = held_rel("Wide&Deep card vs CPU scorer", got, cpu.score(inst)["prob"], 2e-2)
    check(launches == 2, f"Wide&Deep: the scorer launched K1 {launches} times, not 2 (one a table)")
    srv = PredictionServer(servable, port=0, grpc_port=-1, reload_secs=0, device=dev.type)
    srv.start()
    try:
        reply = http_json(srv.port, "/v1/models/wide_n_deep:predict",
                          {"instances": json_instances(inst)})
    finally:
        srv.stop()
    rest = held_rel("Wide&Deep REST vs Scorer.score", reply["predictions"], got, 1e-5)
    log(f"serving Wide&Deep: infer of {preds.shape[0]} te lines ({infer_launches} K1 launches); "
        f"one bucket of 64 va lines, K1 launched {launches} times; card vs CPU scorer max abs "
        f"diff {err:.3e} (bf16 towers, held at 2e-2); REST cont/cat request vs Scorer.score max "
        f"abs diff {rest:.3e}")
    from tf_repos_tpu_torch.models.wide_deep import WideDeep

    ids = WideDeep._offset_ids(torch.from_numpy(batch["cat"]).to(dev))
    res = {"wide_n_deep emb": serving_k1("wide_n_deep emb bucket 64", card.params["emb"], ids),
           "wide_n_deep wide_cat": serving_k1("wide_n_deep wide_cat bucket 64",
                                              card.params["wide_cat"][:, None], ids)}
    del card, cpu
    torch.cuda.empty_cache()
    return {k: (t, bound, launches) for k, (t, bound) in res.items()}


def serving_phase(dev, work):
    """Serving on the card (phase 4b): DeepFM through the HTTP server, ESMM,
    DIN and, from the zoo, IPNN and LR through the scorer, Wide&Deep
    through both. Returns the
    kernel report's phase and launch counts for the serving entries of
    K1."""
    t0 = time.perf_counter()
    names = {"DeepFM": "expand_rows (serving, whole table, DeepFM)",
             "ESMM": "expand_rows (serving, whole table, ESMM)",
             "DIN": "expand_rows (serving, whole table, DIN)"}
    names["LR"] = "expand_rows (serving, whole table, LR)"
    res = {"DeepFM": deepfm_serving(dev, work),
           "ESMM": aliccp_serving(dev, work, "ESMM", ESMM_WIDTH, "esmm_model"),
           "DIN": aliccp_serving(dev, work, "DIN", DIN_WIDTH, "din_model"),
           "LR": zoo_serving(dev, work)}
    # Wide&Deep's two gathers, each entry with the scored batch's K1 count (2)
    for table, r in wd_serving(dev, work).items():
        names[table] = f"expand_rows (serving, whole table, {table})"
        res[table] = r
    log(f"serving phase: {time.perf_counter() - t0:.1f} s")
    phase = {"t": {names[m]: r[0] for m, r in res.items()},
             "bound": {names[m]: r[1] for m, r in res.items()}, "bound_by": "bytes",
             "err": {names[m]: 0.0 for m in res}}
    return phase, {names[m]: r[2] for m, r in res.items()}


def graph_ab(label, step, run, n, ms, examples):
    """The bare step ``run(i, generator)`` eagerly against its CUDA graphs
    (``ms`` a step, timed just before): the same n steps with a dropout
    generator passed, which a keep of 1 never draws from, so the math is
    the graph's and the step stays eager. Logs both and the step object's
    replay, capture and eager counts; returns the eager ms a step."""
    if not isinstance(step, GraphedStep):
        return None
    force = torch.Generator(device=torch.device("cuda"))
    for i in range(2):
        run(i, force)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        run(i, force)
    torch.cuda.synchronize()
    eager = (time.perf_counter() - t0) / n * 1e3
    log(f"bare step {label}: CUDA graph {ms:.3f} ms/step ({examples / ms * 1e3:.0f} examples/s) "
        f"against eager {eager:.3f} ({examples / eager * 1e3:.0f}); step graph: replay "
        f"{step.counts['replay']}, capture {step.counts['capture']}, eager {step.counts['eager']}")
    return eager


def din_bare_step(dev, profile, sorted_bwd, dma_scatter=False):
    """The bare DIN --mh_coo sparse step on pre-mapped batches already on
    the card. profile: None, or the trace path ("" for none)."""
    cfg = Config(**dict(DIN_WIDTH, dma_scatter=dma_scatter))
    model = create_model(cfg)
    raw = esmm_batches(4, seed=3)
    chain = din_chain(model, sorted_aux=sorted_bwd)
    t0 = time.perf_counter()
    mapped = [chain(b) for b in raw]
    host_ms = (time.perf_counter() - t0) / len(raw) * 1e3
    batches = [to_device(b, dev) for b in mapped]
    torch.cuda.reset_peak_memory_stats()
    params, mstate = model.init(torch.Generator().manual_seed(0))
    params = tree_map(lambda x: x.to(dev), params)
    mstate = tree_map(lambda x: x.to(dev), mstate)
    tx = make_optimizer("Adam", cfg.learning_rate)
    sopt = SP.make_sparse_row_optimizer("Adam", cfg.learning_rate, fused_table=True,
                                        dma_scatter=cfg.dma_scatter)
    opt = SP.init_opt_state(model, tx, sopt, params)
    step = SP.build_sparse_train_step(model, tx, sopt, lookup=SR.make_expand_lookup())
    for i in range(5):  # the first call eager, then each batch's graph captured
        params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4])
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for i in range(n):
        params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    label = ("DIN --mh_coo" + (" --coo_sorted_bwd" if sorted_bwd else "")
             + (" --dma_scatter" if dma_scatter else ""))
    check(math.isfinite(float(loss)), f"bare {label} step loss {float(loss)}")
    log(f"bare step {label}: {ms:.3f} ms/step, {EB / ms * 1e3:.0f} examples/s (peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB); host chain (bucketer + packer"
        f"{' with the idx-sorted stream' if sorted_bwd else ''} + mapper) {host_ms:.1f} ms/batch")
    graph_ab(label, step, lambda i, g: step(params, opt, mstate, batches[i % 4], g), n, ms, EB)
    if profile is not None:
        suffix = "_din" + ("_sorted" if sorted_bwd else "") + ("_dma" if dma_scatter else "")
        trace = os.path.splitext(profile)[0] + suffix + ".json" if profile else ""
        profile_step(label, lambda i: step(params, opt, mstate, batches[i % 4]), trace)
    return ms


def bare_steps(dev, profile):
    """profile: None, or the trace path ("" for none) of a profiled window."""
    # the bare sparse step on pre-mapped batches already on the card
    out = {}
    raw = zipf_batches(4)
    rng = np.random.default_rng(8)
    blocks = [synthetic_criteo_batch(rng, B, WIDTH["feature_size"]) for _ in range(4)]
    dense = {"sparse_table_update": False, "fused_table": False, "pallas_expand": False}
    for label, over in (("sparse", {}), ("sparse+catchup", {"sparse_catchup": True}),
                        ("dense+static", dense), ("dense+static, block ids", dense),
                        ("dense+field_blocks", FB_WIDTH)):
        cfg = Config(**dict(WIDTH, **over))
        model = create_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        params, mstate = model.init(torch.Generator().manual_seed(0))
        params = tree_map(lambda x: x.to(dev), params)
        mstate = tree_map(lambda x: x.to(dev), mstate)
        tx = make_optimizer("Adam", cfg.learning_rate)
        if cfg.sparse_table_update:
            sopt = SP.make_sparse_row_optimizer("Adam", cfg.learning_rate, fused_table=True,
                                                catchup=cfg.sparse_catchup)
            opt = SP.init_opt_state(model, tx, sopt, params)
            step = SP.build_sparse_train_step(model, tx, sopt, lookup=SR.make_expand_lookup())
            mapper = SparseBatchMapper(model.sparse_slots())
            batches = [to_device(mapper(dict(b)), dev) for b in raw]
        elif cfg.field_blocks:  # per-field-block ids, the table gradient on K8
            opt = tx.init(params)
            step = L.build_train_step(model, tx, lookup=FB.make_field_block_lookup(
                cfg.feature_size, FB_OFFSETS, FB_SIZES))
            batches = [to_device(b, dev) for b in blocks]
        else:
            opt = tx.init(params)
            step = L.build_train_step(model, tx)
            batches = [to_device(b, dev) for b in (blocks if "block" in label else raw)]
        for i in range(5):  # the first call eager, then each batch's graph captured
            params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4])
        torch.cuda.synchronize()
        n = 30
        t0 = time.perf_counter()
        for i in range(n):
            params, opt, mstate, loss = step(params, opt, mstate, batches[i % 4])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
        check(math.isfinite(float(loss)), f"bare {label} step loss {float(loss)}")
        out[label] = ms
        log(f"bare step {label}: {ms:.3f} ms/step, {B / ms * 1e3:.0f} examples/s "
            f"(peak mem {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB)")
        if label == "sparse":
            out["sparse, eager"] = graph_ab(
                "DeepFM sparse", step, lambda i, g: step(params, opt, mstate, batches[i % 4], g),
                n, ms, B)
        if profile is not None and label == "sparse":
            profile_step("DeepFM sparse", lambda i: step(params, opt, mstate, batches[i % 4]), profile)
        if profile is not None and label == "dense+field_blocks":
            trace = os.path.splitext(profile)[0] + "_fb.json" if profile else ""
            profile_step("DeepFM dense --field_blocks", lambda i: step(params, opt, mstate, batches[i % 4]),
                         trace)
    return out


def profile_step(label: str, run, trace: str):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(10):
            run(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator row repeats the time of the kernels it
    # launched. No busy share: summed rows count concurrent streams twice
    # (the benchmark's device_idle_share.train takes their union)
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    log(f"profile {label}: 10 steps, {wall:.2f} ms wall, {sum(r[2] for r in rows) / 10:.1f} "
        "device operations per step" if rows else "profile: no device time recorded")
    for us, key, cnt in rows[:25]:
        log(f"profile:   {us / 10 / 1e3:8.4f} ms/step  x{cnt / 10:<4.1f} {key[:90]}")
    if trace:
        os.makedirs(os.path.dirname(os.path.abspath(trace)), exist_ok=True)
        prof.export_chrome_trace(trace)


# ------------------------------------------------------------------ phase 5
def card_vs_cpu(label, cfg, mapped, dev, dense, gates=False):
    """5 sparse steps on the card (kernels) and on the CPU (plain versions)
    from the same weights and mapped batches, step by step, under
    cfg.optimizer's row form (on the fused store under cfg.fused_table);
    ``dense(params)`` picks the dense leaves to compare. Held: the loss
    within 1e-4 relative, every row store (w|m|v, or the table and its
    state's stores) and the dense leaves within 1e-4. gates: a
    third run, on the CPU with the card's ReLU gates (ReluGates), is the
    one whose weights are held; the CPU's own-gate weights and the count
    of its gates that differ from the card's are printed, not held
    (field_block_trajectory says why a gate within f32 round-off of 0
    moves the weights by steps of lr, not by round-off).

    Under cfg.param_dtype=bfloat16 the tables and their stores are bf16,
    every run rounds its write-backs with the noise of a CPU generator of
    the same seed, drawn through the noise seam (rounding.sr_noise, here
    replaced by a CPU draw copied to the run's device, for this check
    only); the bf16 stores' elements apart and their most ulps apart are
    printed, not held here: a rounding moved by the last f32 bit of a sum
    taken in another order on the card parts the two runs by one ulp, and
    later steps carry and grow it, so bf16_step_check holds each row
    update on the card's own inputs instead; cfg.fused_moments and
    cfg.sparse_catchup pick the row forms as the harness does.

    Returns {"flips": the CPU's own gates that differ from the card's (None
    without gates), "own": the CPU's own-gate differences, "held": the
    held ones}, each as the tuple that is printed (loss rel diff, f32
    store diff, dense diff, bf16 elements apart, most ulps, bf16
    elements)."""
    model = create_model(cfg)
    (table,) = model.sparse_slots()
    p0, m0 = model.init(torch.Generator().manual_seed(3))
    bf16 = cfg.param_dtype in ("bfloat16", "bf16")
    legs = [("card", dev.type, "record"), ("cpu", "cpu", "count")]
    if gates:
        legs.insert(1, ("cpu, card's gates", "cpu", "replay"))
    runs = {}
    for name, where, mode in legs:
        d = torch.device(where)
        params = tree_map(lambda x: x.clone().to(d), p0)
        if bf16:
            params = SP.cast_tables(model, params, torch.bfloat16)
        tx = make_optimizer(cfg.optimizer, cfg.learning_rate)
        sopt = SP.make_sparse_row_optimizer(cfg.optimizer, cfg.learning_rate,
                                            fused_moments=cfg.fused_moments,
                                            fused_table=cfg.fused_table,
                                            catchup=cfg.sparse_catchup,
                                            dma_scatter=cfg.dma_scatter)
        runs[name] = {"d": d, "params": params, "opt": SP.init_opt_state(model, tx, sopt, params),
                      "mstate": tree_map(lambda x: x.clone().to(d), m0), "mode": mode,
                      "sr": torch.Generator().manual_seed(11) if bf16 else None,
                      "step": SP.build_sparse_train_step(model, tx, sopt,
                                                         lookup=SR.make_expand_lookup())}
    relu = ReluGates() if gates else None
    draw = RD.sr_noise
    if bf16:
        RD.sr_noise = lambda shape, generator, device: draw(shape, generator, "cpu").to(device)
    try:
        step_legs(runs, mapped, relu)
    finally:
        RD.sr_noise = draw

    def diff(a, b):
        """(loss rel diff, f32 and int store diff, dense diff, bf16 store
        elements apart, their most ulps apart, bf16 store elements)."""
        ra, rb = runs[a], runs[b]
        sa, sb = ra["opt"]["sparse"][table], rb["opt"]["sparse"][table]
        werr, apart, ulps, n16 = 0.0, 0, 0, 0
        for k in sorted(sa):
            if not isinstance(sa[k], torch.Tensor):
                continue
            x, y = sa[k].cpu(), sb[k].cpu()
            if x.dtype == torch.bfloat16:
                u = (x.view(torch.int16).int() - y.view(torch.int16).int()).abs()
                apart, ulps, n16 = apart + int((u > 0).sum()), max(ulps, int(u.max())), n16 + u.numel()
            else:
                werr = max(werr, float((x.double() - y.double()).abs().max()))
        return (max(abs(x - y) / abs(x) for x, y in zip(ra["losses"], rb["losses"])), werr,
                max(float((x.cpu() - y.cpu()).abs().max())
                    for x, y in zip(dense(ra["params"]), dense(rb["params"]))), apart, ulps, n16)

    def line(r):
        rel, werr, derr, apart, ulps, n16 = r
        return (f"max rel loss diff {rel:.3e}, max |{stores}| diff {werr:.3e}"
                + (f", bf16 stores: {apart} of {n16} elements apart, at most {ulps} ulp (not held)"
                   if bf16 else "") + f", dense diff {derr:.3e}")

    r = diff("cpu", "card")
    stores = "+".join(k for k in sorted(runs["card"]["opt"]["sparse"][table])
                      if isinstance(runs["card"]["opt"]["sparse"][table][k], torch.Tensor))
    log(f"trajectory {label} {'bf16 stores' if bf16 else 'f32'}, 5 steps: losses cpu "
        f"{runs['cpu']['losses']} card {runs['card']['losses']}; {line(r)}"
        + (" (not held)" if gates else ""))
    check(r[0] <= 1e-4, f"{label}: card vs CPU loss trajectory differs: {r[0]}")
    own = r
    if gates:
        r = diff("cpu, card's gates", "card")
        log(f"trajectory {label}, the CPU with the card's ReLU gates: {relu.flips} of the CPU's "
            f"own gates differ from the card's; {line(r)}")
        check(r[0] <= 1e-4, f"{label}: card vs CPU with the card's gates: loss differs: {r[0]}")
    check(r[1] <= 1e-4 and r[2] <= 1e-4, f"{label}: card vs CPU weights differ: {r[1]} {r[2]}")
    return {"flips": relu.flips if gates else None, "own": own, "held": r}


def trajectory(dev):
    cfg = Config(**dict(WIDTH, batch_size=1024, compute_dtype="float32"))
    mapper = SparseBatchMapper(create_model(cfg).sparse_slots())
    mapped = [mapper(b) for b in zipf_batches(5, seed=7, batch=1024)]
    card_vs_cpu("DeepFM B=1024", cfg, mapped, dev, lambda p: [p["fm_b"], p["out"]["w"]])


def esmm_trajectory(dev):
    cfg = Config(**dict(ESMM_WIDTH, feature_size=50_000, batch_size=512, multi_hot_pad=64,
                        compute_dtype="float32"))
    chain = esmm_chain(create_model(cfg))
    mapped = [chain(b) for b in esmm_batches(5, seed=7, batch=512, vocab=50_000, pad=64)]
    card_vs_cpu("ESMM --mh_coo --dma_scatter B=512 vocab 50k pad 64", cfg, mapped, dev,
                lambda p: [p["ctr_out"]["w"], p["cvr_out"]["w"]])


def din_trajectory(dev):
    """card_vs_cpu for DIN --mh_coo, with and without --coo_sorted_bwd, at
    B=512, vocab 50k, pad 64, f32 towers. Both legs hold their weights
    with the card's ReLU gates replayed on the CPU: the card's index_add
    sums run in a new order on each run, a few of the attention MLP's
    gates sit within f32 round-off of 0 at this point, and one more of
    them flipping moves a table element by Adam's lr (5.37e-4 where it
    did); scripts/torch_gate_flips.py repeats the check and counts the
    flips."""
    cfg = Config(**dict(DIN_WIDTH, feature_size=50_000, batch_size=512, multi_hot_pad=64,
                        compute_dtype="float32"))
    model = create_model(cfg)
    raw = esmm_batches(5, seed=7, batch=512, vocab=50_000, pad=64)
    for sorted_bwd in (False, True):
        chain = din_chain(model, sorted_aux=sorted_bwd)
        card_vs_cpu(f"DIN --mh_coo{' --coo_sorted_bwd' if sorted_bwd else ''} B=512 vocab 50k "
                    "pad 64", cfg, [chain(b) for b in raw], dev,
                    lambda p: [p["out"]["w"], p["att_out"]["w"], p["att_mlp"]["layers"][0]["dense"]["w"]],
                    gates=True)


def zoo_trajectory(dev):
    """card_vs_cpu for the seven kernel models of the zoo: each at its
    published width on a 50k vocab, B=1,024, f32 towers, no dropout, on
    Zipf(1.2) batches through its mapper; beside the w|m|v rows, the out
    projection and the first tower layer (DCN's cross weights, DeepMVM's
    field bias). OPNN's and DeepMVM's weights are held with the card's
    ReLU gates on the CPU: each of OPNN's first layer's 262,144
    pre-activations sums 760,032 products, and those within f32 round-off
    of 0 take their gate by the order of the sums; DeepMVM's towers hold
    13-36 pre-activations within 1e-6 of 0 a call at this point (counted
    on the CPU), and one flipped gate moved a table row by 1.5 lr in one
    run."""
    first = lambda p: p["mlp"]["layers"][0]["dense"]["w"]  # noqa: E731
    dense = {"AFM": lambda p: [p["out"]["w"], p["att_mlp"]["layers"][0]["dense"]["w"]],
             "DCN": lambda p: [p["out"]["w"], first(p), p["cross_w"]],
             "DeepMVM": lambda p: [p["out"]["w"], first(p), p["mvm_b"]]}
    raw = zipf_batches(5, seed=7, batch=ZOO_TRAJ_B, vocab=50_000)
    for name in ZOO:
        if name == "LR":
            continue
        t0 = time.perf_counter()
        cfg = Config(**dict(zoo_width(name), feature_size=50_000, batch_size=ZOO_TRAJ_B,
                            compute_dtype="float32"))
        mapper = SparseBatchMapper(create_model(cfg).sparse_slots())
        card_vs_cpu(f"zoo {name} B={ZOO_TRAJ_B} vocab 50k", cfg, [mapper(dict(b)) for b in raw], dev,
                    dense.get(name, lambda p: [p["out"]["w"], first(p)]),
                    gates=name in ("OPNN", "DeepMVM"))
        log(f"trajectory zoo {name}: {time.perf_counter() - t0:.1f} s")


def lazy_trajectory(dev):
    """card_vs_cpu for the other optimizers' lazy row forms: DeepFM at
    B=1,024, f32 towers, on the unfused store with K1/K2 on the card."""
    cfg0 = Config(**dict(LAZY_WIDTH, batch_size=1024, compute_dtype="float32"))
    mapper = SparseBatchMapper(create_model(cfg0).sparse_slots())
    mapped = [mapper(b) for b in zipf_batches(5, seed=7, batch=1024)]
    for opt in LAZY_OPTS:
        cfg = cfg0.replace(optimizer=opt)
        card_vs_cpu(f"DeepFM lazy {opt} B=1024", cfg, mapped, dev,
                    lambda p: [p["fm_b"], p["out"]["w"], p["mlp"]["layers"][0]["dense"]["w"]])


def wd_trajectory(dev):
    """5 dense Wide&Deep steps (wdl, f32 towers, B=1,024) on the card and on
    the CPU from the same weights and batches (uniform ids over all 10,000
    buckets of each column). Held: the loss within 1e-4 relative and every
    weight within 1e-4, on the CPU's own ReLU gates when none of them
    differs from the card's; otherwise on a third run, the CPU with the
    card's gates (the count of differing gates is printed either way)."""
    cfg = Config(**dict(WD_WIDTH, batch_size=1024, compute_dtype="float32"))
    model = create_model(cfg)
    rng = np.random.default_rng(7)
    batches = [{"cont": rng.random((1024, 13)).astype(np.float32),
                "cat": rng.integers(0, WD_BUCKETS, (1024, 26)).astype(np.int32),
                "label": (rng.random(1024) < 0.5).astype(np.float32),
                "mask": np.ones(1024, np.float32)} for _ in range(5)]
    p0, m0 = model.init(torch.Generator().manual_seed(3))
    runs = {}
    for label, where, mode in (("card", dev.type, "record"), ("cpu, card's gates", "cpu", "replay"),
                               ("cpu", "cpu", "count")):
        d = torch.device(where)
        params = tree_map(lambda x: x.clone().to(d), p0)
        tx = make_optimizer("wdl", cfg.learning_rate, model.model_type)
        runs[label] = {"d": d, "params": params, "opt": tx.init(params), "mode": mode,
                       "mstate": tree_map(lambda x: x.clone().to(d), m0),
                       "step": L.build_train_step(model, tx)}
    gates = ReluGates()
    step_legs(runs, batches, gates)

    def diff(a, b):
        ra, rb = runs[a], runs[b]
        return (max(abs(x - y) / abs(x) for x, y in zip(ra["losses"], rb["losses"])),
                max(float((x.cpu() - y.cpu()).abs().max())
                    for x, y in zip(tree_leaves(ra["params"]), tree_leaves(rb["params"]))))

    rel, w_own = diff("cpu", "card")
    rel_g, w_g = diff("cpu, card's gates", "card")
    log(f"trajectory Wide&Deep wdl B=1024 f32, 5 steps: losses cpu {runs['cpu']['losses']} card "
        f"{runs['card']['losses']}; max rel loss diff {rel:.3e}, max weight diff {w_own:.3e}; "
        f"{gates.flips} of the CPU's ReLU gates differ from the card's; with the card's gates: "
        f"max rel loss diff {rel_g:.3e}, max weight diff {w_g:.3e}")
    check(rel <= 1e-4, f"Wide&Deep: card vs CPU loss trajectory differs: {rel}")
    held = w_own if gates.flips == 0 else w_g
    check(held <= 1e-4 and rel_g <= 1e-4, f"Wide&Deep: card vs CPU weights differ: {held}")


def step_legs(runs, batches, gates=None):
    """Steps each run (a dict of its device "d", "params", "opt", "mstate"
    and "step") through the batches, batch by batch, in the order of
    ``runs``, and collects its "losses". gates: a ReluGates put in place
    of torch.relu for the runs, each taking the gate mode of its "mode"
    key (the first run records each batch's gates)."""
    for r in runs.values():
        r["losses"] = []
        if gates and isinstance(r["step"], GraphedStep):
            # a replay runs no Python: the gates are recorded and replayed eagerly
            r["step"].eager_only = "ReLU gates recorded on the host"
    if gates:
        torch.relu = gates
    try:
        for b in batches:
            if gates:
                gates.gates = []
            for r in runs.values():
                if gates:
                    gates.mode, gates.i = r["mode"], 0
                # a run over bf16 stores also takes its rounding generator
                sr = (None, r["sr"]) if r.get("sr") is not None else ()
                r["params"], r["opt"], r["mstate"], loss = r["step"](
                    r["params"], r["opt"], r["mstate"], to_device(b, r["d"]), *sr)
                r["losses"].append(float(loss))
    finally:
        if gates:
            torch.relu = gates.relu


class ReluGates:
    """Stands in for torch.relu (the towers' only gate) to line up the
    ReLU gates of two runs: "record" keeps each call's gate (x > 0) in
    call order, "replay" applies the recorded gate at the same call (value
    and gradient as relu's where the gate is open, else 0), "count" runs
    relu and counts the elements whose own gate differs from the
    recorded one."""

    def __init__(self):
        self.relu, self.gates, self.i, self.mode, self.flips = torch.relu, [], 0, "record", 0

    def __call__(self, x):
        if self.mode == "record":
            self.gates.append(x > 0)
            return self.relu(x)
        gate = self.gates[self.i].to(x.device)
        self.i += 1
        if self.mode == "replay":
            return torch.where(gate, x, torch.zeros_like(x))
        self.flips += int(((x > 0) != gate).sum())
        return self.relu(x)


def field_block_trajectory(dev):
    """5 dense --field_blocks steps (f32 towers, K8 in f32 mode) from the
    same weights and batches, step by step on the card and twice on the
    CPU (K8's plain version): once with the CPU's own ReLU gates and once
    with the card's. Held: loss within 1e-4 relative (own gates), every
    weight within 1e-4 (the card's gates). Printed, not held: the weights
    with the CPU's own gates, and how many of its gates differ from the
    card's. A tower pre-activation within f32 round-off of 0 takes its gate
    by the order of the sums, which differs between card and CPU; one such
    flip changes that example's input gradient by a finite step, not by
    round-off, and the per-field blocks hit most table rows at most
    once a batch, so those rows' gradients are that one example's. Adam
    turns the changed gradients, and tower gradients near 1e-8, into steps
    of up to lr of another size or sign, and the whole weight set moves
    apart by up to several lr in 5 steps. Lining the gates up removes
    that, and what is left is the round-off of K8, the GEMMs and Adam."""
    cfg = Config(**dict(FB_WIDTH, batch_size=1024, compute_dtype="float32"))
    model = create_model(cfg)
    rng = np.random.default_rng(7)
    batches = [synthetic_criteo_batch(rng, 1024, cfg.feature_size) for _ in range(5)]
    p0, m0 = model.init(torch.Generator().manual_seed(3))
    k8 = FB.make_field_block_lookup(cfg.feature_size, FB_OFFSETS, FB_SIZES, use_bf16=False)
    runs = {}
    for label, where, mode in (("card", dev.type, "record"), ("cpu, card's gates", "cpu", "replay"),
                               ("cpu", "cpu", "count")):
        d = torch.device(where)
        params = tree_map(lambda x: x.clone().to(d), p0)
        tx = make_optimizer("Adam", cfg.learning_rate)
        runs[label] = {"d": d, "params": params, "opt": tx.init(params), "mode": mode,
                       "mstate": tree_map(lambda x: x.clone().to(d), m0),
                       "step": L.build_train_step(model, tx, lookup=k8)}
    gates = ReluGates()
    step_legs(runs, batches, gates)

    def diff(a, b):
        ra, rb = runs[a], runs[b]
        return (max(abs(x - y) / abs(x) for x, y in zip(ra["losses"], rb["losses"])),
                max(float((x.cpu() - y.cpu()).abs().max())
                    for x, y in zip(tree_leaves(ra["params"]), tree_leaves(rb["params"]))))

    rel, w_own = diff("cpu", "card")
    rel_g, w_g = diff("cpu, card's gates", "card")
    n_gates = sum(g.numel() for g in gates.gates) * len(batches)
    log(f"trajectory DeepFM dense --field_blocks B=1024 f32, 5 steps: losses cpu "
        f"{runs['cpu']['losses']} card {runs['card']['losses']}; max rel loss diff {rel:.3e}; "
        f"with the card's ReLU gates on the CPU: max rel loss diff {rel_g:.3e}, max weight diff "
        f"{w_g:.3e}; with the CPU's own gates: {gates.flips} of {n_gates} gates differ from the "
        f"card's, max weight diff {w_own:.3e} (not held)")
    check(rel <= 1e-4, f"DeepFM --field_blocks: card vs CPU loss trajectory differs: {rel}")
    check(rel_g <= 1e-4 and w_g <= 1e-4,
          f"DeepFM --field_blocks: card vs CPU with the card's gates differ: {rel_g} {w_g}")


# ------------------------------------------- bf16 stores, the slim wire, the presets
# the single-process presets at full width: the DeepFM benchmark point's
# model widths on its files, the published Ali-CCP point's on the ESMM
# lines (scripts/bench_published.py:77-83, 186-187); each preset's own
# flags otherwise (config.PRESETS)
CRITEO_MODEL = {k: WIDTH[k] for k in ("model", "feature_size", "field_size", "embedding_size",
                                      "deep_layers", "dropout", "learning_rate", "l2_reg",
                                      "optimizer")}
ALI_MODEL = {k: ESMM_WIDTH[k] for k in ("feature_size", "field_size", "embedding_size",
                                        "deep_layers", "dropout", "learning_rate", "l2_reg",
                                        "optimizer")}
PRESET_WIDTH = {
    "criteo_headline": CRITEO_MODEL,
    "criteo_singlepass": CRITEO_MODEL,
    "esmm_large_vocab": dict(ALI_MODEL, model="ESMM"),
    "din_large_vocab": dict(ALI_MODEL, model="DIN", attention_layers="256", attention_pooling=True),
}
# the kernels each preset's step launches, and how many times a step
PRESET_KERNELS = {
    "criteo_headline": {},
    "criteo_singlepass": {"expand_rows": 1, "accumulate_rows": 1},
    "esmm_large_vocab": {"expand_rows": 1, "accumulate_rows": 1, "coo_pool_rows": 1,
                         "coo_accumulate_rows": 1},
    "din_large_vocab": {"expand_rows": 2, "accumulate_rows": 2, "sorted_segsum": 2,
                        "sorted_expand": 2},
}
COUNTED = (SR.expand_rows, SR.accumulate_rows, CP.coo_pool_rows, CP.coo_accumulate_rows,
           SG.sorted_segsum, SG.sorted_expand, RS.dma_row_scatter, FB.field_block_scatter)
# the edge values of the rounding: +-inf, NaNs (quiet, with a payload,
# signalling, the all-ones one that wraps to +0), the largest finite
# (rounds up to inf), +-0, subnormals, ordinary values
SR_EDGE = np.array([0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7FC10000, 0x7F800001,
                    0x7F80FFFF, 0xFFA12345, 0xFFFFFFFF, 0x7F7FFFFF, 0xFF7FFFFF, 0x00000000,
                    0x80000000, 0x00000001, 0x807FFFFF, 0x3F800000, 0xBF800001, 0x3F80FFFF],
                   np.uint32)


def preset_argv(dev, work, name, model_dir):
    """The CLI flags of a preset run: --preset=<name>, the model widths,
    the data and model directories. Log cadence: the Criteo presets log
    every 8 steps (their dispatch group); the Ali-CCP ones run 10 steps,
    fewer than one group of 64 (ESMM) or than two of 8 (DIN), so they take
    --steps_per_dispatch=5 (a plain loop of steps either way) to log at
    steps 5 and 10."""
    criteo = name.startswith("criteo")
    over = ["--log_steps=8"] if criteo else ["--steps_per_dispatch=5", "--log_steps=5"]
    return [f"--preset={name}"] + [f"--{k}={v}" for k, v in PRESET_WIDTH[name].items()] + [
        "--num_epochs=1", f"--data_dir={work}/{'data' if criteo else 'esmm_data'}",
        f"--model_dir={work}/{model_dir}/", "--dt_dir=smoke", "--eval_throttle_secs=0",
        f"--device={dev.type}", "--seed=2018", *over]


def rounding_phase(dev):
    """Stochastic rounding on the card: bit-identical to the CPU given the
    same noise, on the edge values and 1M random bit patterns; rounding
    up 0.25 of a bf16 ulp above 1.0 at a rate of 0.25 +- 0.01 over
    200,000 draws from a generator on the card; its time on the ESMM
    point's [S, 3K] rows (plain PyTorch, not a kernel)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([np.repeat(SR_EDGE, 1000),
                        rng.integers(0, 2 ** 32, 1_000_000, dtype=np.uint32)]).view(np.float32)
    xt = torch.from_numpy(x)
    for label, noise in (("random", rng.integers(0, 1 << 16, x.size).astype(np.int32)),
                         ("0", np.zeros(x.size, np.int32)),
                         ("0xFFFF", np.full(x.size, 0xFFFF, np.int32))):
        nt = torch.from_numpy(noise)
        want = RD.round_bits(xt, nt).view(torch.int16)
        got = RD.round_bits(xt.to(dev), nt.to(dev)).view(torch.int16).cpu()
        check(torch.equal(got, want), f"rounding on the card differs from the CPU (noise {label}): "
                                      f"{int((got != want).sum())} elements")
    n, ulp = 200_000, 2.0 ** -7
    gen = torch.Generator(device=dev).manual_seed(0)
    up = RD.stochastic_round_bf16(torch.full((n,), 1.0 + 0.25 * ulp, device=dev), gen).float()
    rate = float((up > 1.0).float().mean())
    check(abs(rate - 0.25) <= 0.01, f"rounding up at 0.25 ulp happens at {rate}")
    rows = torch.randn((114_688, 48), device=dev)
    ms = cuda_ms(lambda: RD.stochastic_round_bf16(rows, gen))
    log(f"rounding: card == CPU bit for bit on {x.size} values (the {SR_EDGE.size} edge values "
        f"included) at three noises; up-rate at 0.25 ulp {rate:.4f} over {n} card draws; "
        f"{ms:.4f} ms for [114688, 48] (noise draw and rounding, plain PyTorch)")


def bf16_store_kernel_phase(dev):
    """K1 and K2 on rows gathered from the fused [4,500,001, 48] bf16 w|m|v
    store at the esmm_large_vocab point (the ESMM point's uids, S =
    114,688; K1's ids the 14 single-valued fields): the step's f32 upcast
    of the store's rows (train/sparse.take_rows_f32), as k1_k2_point holds
    and times them; beside, the row gather from the bf16 store and from an
    f32 one of the same rows (plain PyTorch)."""
    pt = esmm_point(dev)
    k, s = pt["k"], pt["s"]
    uids = torch.from_numpy(pt["mapped"]["__uids_emb"]).to(dev)
    v = ESMM_WIDTH["feature_size"]
    store = torch.randn((v + 1, 3 * k), generator=pt["gen"], device=dev).to(torch.bfloat16)
    store[-1].zero_()
    su = SP.take_rows_f32(store, uids)
    out = {"t": {}, "bound": {}, "bound_by": {}, "err": {}}
    k1_k2_point(out, "bf16 store, ESMM point", "ESMM's single-valued lookup on bf16-store rows",
                su, k, pt["ids"], s, pt["gen"])
    g16 = cuda_ms(lambda: SP.take_rows_f32(store, uids))
    f32 = store.float()
    g32 = cuda_ms(lambda: SP.take_rows_f32(f32, uids))
    log(f"bf16 store [{v + 1}, {3 * k}]: {store.numel() * 2 / 2**20:.0f} MiB (f32 "
        f"{store.numel() * 4 / 2**20:.0f} MiB); the step's row gather of S={s} rows "
        f"{g16:.4f} ms from bf16, {g32:.4f} ms from f32 (plain index_select + upcast)")
    del store, f32
    torch.cuda.empty_cache()
    return out


def store_bytes(h, state):
    """(bytes, bytes in f32) of the sparse tables and their optimizer
    state: the lazy step's row stores, or the dense step's tables and
    their Adam moments."""
    if h._sopt is not None:
        xs = [x for aux in state["opt_state"]["sparse"].values() for x in aux.values()
              if isinstance(x, torch.Tensor)]
    else:
        v = h.cfg.feature_size
        xs = [x for x in tree_leaves(state["params"]) + tree_leaves(state["opt_state"])
              if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == v]
    return (sum(x.numel() * x.element_size() for x in xs),
            sum(x.numel() * (4 if x.is_floating_point() else x.element_size()) for x in xs))


def first_batches(h, n):
    batches = []
    for b in h._dataset("tr", shuffle=True, epochs=1):
        batches.append(b)
        if len(batches) == n:
            break
    return batches


def wire_bytes(batches, b):
    return sum(np.asarray(x).nbytes for bb in batches for x in bb.values()) / (len(batches) * b)


def decoded_equal(label, slim_h, slim, full, dev):
    """The slim batches decoded on the card equal the full ones moved to
    it (the compact segment stream aside, which the model rebuilds; the
    live counts compared as int32)."""
    for i, (s, f) in enumerate(zip(slim, full)):
        got = slim_h.model._decode(to_device(s, dev))
        want = to_device(f, dev)
        want.pop(MHC_CDEST, None)
        if MHC_CNT in want:
            want[MHC_CNT] = want[MHC_CNT].to(torch.int32)
        check(sorted(got) == sorted(want), f"{label}: decoded keys {sorted(got)} vs {sorted(want)}")
        for k in want:
            check(got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]),
                  f"{label}: decoded batch {i} differs at {k}")


def run_steps(h, batches, dev, n):
    """n steps of the harness's own train step from its init on the given
    host batches (cycled); returns (losses, state)."""
    state = h.init_train_state()
    state = {k: state[k] for k in ("params", "opt_state", "mstate")}
    step = h._get_train_step()
    gen = torch.Generator(device=dev).manual_seed(h.cfg.seed + 1)
    sr = torch.Generator(device=dev).manual_seed(h.cfg.seed + 2)
    dbs = [to_device(b, dev) for b in batches]
    losses = []
    for i in range(n):
        state, loss = step(state, dbs[i % len(dbs)], gen, sr)
        losses.append(float(loss))
    return losses, state


def preset_bare(dev, work, name):
    """A preset's harness off the CLI: its first training batches with and
    without --slim_transfer (each preset gets both, whichever it sets),
    their wire bytes per example, the host encode of one batch, the
    decoded slim batches held equal to the full ones on the card, the
    table and state bytes against f32, and the bare step (10 steps on 4
    pre-built batches on the card, after 3). criteo_singlepass and
    esmm_large_vocab also run 3 steps on each wire from the same init:
    losses within 1e-6 relative."""
    cfg = parse_config(preset_argv(dev, work, name, f"bare_{name}"))
    hs, hf = Harness(cfg.replace(slim_transfer=True)), Harness(cfg.replace(slim_transfer=False))
    slim, full = first_batches(hs, 4), first_batches(hf, 4)
    b = cfg.batch_size
    out = {"wire slim": wire_bytes(slim, b), "wire full": wire_bytes(full, b)}
    if name.startswith("criteo"):
        from tf_repos_tpu_torch.data.slim_wire import encode_batch

        out["encode ms"] = best_s(lambda: encode_batch(full[0], cfg.static_fields))[0] * 1e3
    else:
        from tf_repos_tpu_torch.data.slim_wire import AliccpSlimEncoder

        enc = AliccpSlimEncoder(**hf._aliccp_encoder_args())
        out["encode ms"] = best_s(lambda: enc(dict(full[0])))[0] * 1e3
    decoded_equal(name, hs, slim, full, dev)
    if name in ("criteo_singlepass", "esmm_large_vocab"):
        ls, _ = run_steps(hs, slim, dev, 3)
        lf, _ = run_steps(hf, full, dev, 3)
        rel = max(abs(x - y) / abs(y) for x, y in zip(ls, lf))
        log(f"{name}: slim vs full wire, 3 steps from one init: losses {ls} vs {lf} (max rel "
            f"{rel:.2e}, held at 1e-6)")
        check(rel <= 1e-6, f"{name}: the slim and the full wire train to other losses")
    h = hs if cfg.slim_transfer else hf
    own = slim if cfg.slim_transfer else full
    torch.cuda.reset_peak_memory_stats()
    losses, state = run_steps(h, own, dev, 3)
    out["store"], out["store f32"] = store_bytes(h, state)
    step = h._get_train_step()
    gen = torch.Generator(device=dev).manual_seed(1)
    sr = torch.Generator(device=dev).manual_seed(2)
    dbs = [to_device(x, dev) for x in own]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(10):
        state, loss = step(state, dbs[i % 4], gen, sr)
    torch.cuda.synchronize()
    out["bare ms"] = (time.perf_counter() - t0) / 10 * 1e3
    out["bare peak"] = torch.cuda.max_memory_allocated()
    check(math.isfinite(float(loss)), f"{name}: bare step loss {float(loss)}")
    if name == "esmm_large_vocab":
        out["kernel batch"] = hs.model._decode(to_device(slim[0], dev))
    if name == "din_large_vocab":
        out["kernel batch"] = (hs.model._decode(to_device(slim[0], dev)), to_device(full[0], dev))
    del state, dbs, hs, hf
    torch.cuda.empty_cache()
    return out


def slim_decoded_kernels(dev, esmm_batch, din_batches):
    """K3 and K4 on the COO stream the card decoded from the
    esmm_large_vocab wire (idx from lo/hi or u16, dest from the counts, w
    from the wire or the live mask), and K5 and K6 on DIN's compact
    segment stream rebuilt on the card from the wire's counts, as
    models/din.py rebuilds it (held equal to the packer's first): each
    against its plain version (K3, K4, K5 within 1e-4 * sum |terms| +
    1e-6 per element; K6 bit-exact)."""
    gen = torch.Generator(device=dev).manual_seed(13)
    k = ESMM_WIDTH["embedding_size"]
    b = esmm_batch
    idx, dest, w = (b[key].reshape(-1) for key in (MHC_IDX, MHC_DEST, MHC_W))
    s = b["__uids_emb"].shape[0]
    g = b["y"].shape[0] * len(create_model(Config(**ESMM_WIDTH)).mh_coo_groups())
    table = torch.randn((s, 3 * k), generator=gen, device=dev)[:, :k]
    errs = {}
    got = CP.coo_pool_rows(table, idx, dest, w, g)
    errs["K3"] = held("coo_pool_rows (slim-decoded ESMM stream)", got,
                      CP.coo_pool_rows_plain(table, idx, dest, w, g),
                      CP.coo_pool_rows_plain(table.abs(), idx, dest, w.abs(), g))
    dp = torch.randn((g, k), generator=gen, device=dev)
    errs["K4"] = held("coo_accumulate_rows (slim-decoded ESMM stream)",
                      CP.coo_accumulate_rows(dp, idx, dest, w, s),
                      CP.coo_accumulate_rows_plain(dp, idx, dest, w, s),
                      CP.coo_accumulate_rows_plain(dp.abs(), idx, dest, w.abs(), s))
    dec, full = din_batches
    cnt = dec[MHC_CNT].reshape(-1)
    m = dec[MHC_IDX].shape[-1]
    nz = cnt > 0
    c_ix = torch.clamp(torch.cumsum(nz.to(torch.int32), 0, dtype=torch.int32) - 1, min=0)
    cdest = torch.repeat_interleave(torch.cat([c_ix, c_ix.new_zeros(1)]),
                                    torch.cat([cnt, (m - cnt.sum()).to(cnt.dtype).reshape(1)]),
                                    output_size=m)
    check(torch.equal(cdest, full[MHC_CDEST].reshape(-1)),
          "DIN: the compact stream rebuilt from the wire's counts differs from the packer's")
    gc = cnt.numel()
    vals = torch.randn((m, k), generator=gen, device=dev)
    errs["K5"] = held("sorted_segsum (DIN, cdest rebuilt from the counts)",
                      SG.sorted_segsum(vals, cdest, gc), SG.sorted_segsum_plain(vals, cdest, gc),
                      SG.sorted_segsum_plain(vals.abs(), cdest, gc))
    src = torch.randn((gc, k), generator=gen, device=dev)
    check(torch.equal(SG.sorted_expand(src, cdest), SG.sorted_expand_plain(src, cdest)),
          "sorted_expand (DIN, cdest rebuilt from the counts) differs from its plain version")
    log(f"kernels on slim-decoded inputs: ESMM M={idx.numel()} (live {int(w.ne(0).sum())}), "
        f"S={s}, G={g}; DIN M={m}, {gc} bags; max abs err "
        + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()) + ", K6 bit-exact")


def preset_cli(dev, work, name):
    """A preset through the CLI: train (every launch counter zeroed just
    before and read just after; each kernel of the preset's step
    launched as often as it runs a step, the others not at all), eval
    (its loss the train run's final eval's within 1e-4 relative) and
    export; a bf16 run's servable scored on 64 va lines by the card's and
    a CPU scorer, held at 2e-2. Returns (result, launches, CLI
    examples/s, peak device memory of the train run)."""
    argv = preset_argv(dev, work, name, f"preset_{name}")
    for mod in (SR, CP, SG, RS, FB):
        mod.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepClock() as clock:
        res = cli.main(["--task_type=train", *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {f.__name__: f.launches for f in COUNTED}
    cfg = parse_config(argv)
    rate = clock.ex_per_s(cfg.batch_size)
    steps = res["step"]
    log(f"preset {name}: {steps} steps in {wall:.1f} s wall, launches {launches}; CLI {rate:.0f} "
        f"examples/s; peak device memory {peak / 2**30:.2f} GiB")
    check(steps >= ESMM_STEPS and math.isfinite(res["loss"]), f"preset {name}: {res}")
    for k, c in launches.items():
        want = PRESET_KERNELS[name].get(k, 0) * steps
        check(c == want, f"preset {name}: {k} launched {c} times in {steps} steps, expected {want}")
    ev = cli.main(["--task_type=eval", *argv])
    check(abs(ev["loss"] - res["loss"]) <= 1e-4 * abs(res["loss"]),
          f"preset {name}: eval {ev['loss']} vs the train run's final eval {res['loss']}")
    servable = os.path.dirname(cli.main(["--task_type=export", *argv]))
    check(os.path.isdir(servable), f"preset {name}: no servable at {servable}")
    if cfg.param_dtype in ("bfloat16", "bf16"):
        card = Scorer(servable, batch_buckets=(64,), device=dev.type)
        cpu = Scorer(servable, batch_buckets=(64,), warmup=False, device="cpu")
        with open(os.path.join(work, "esmm_data", "va.samples.txt"), "rb") as f:
            lines = [next(f) for _ in range(64)]
        batch = parse_aliccp_lines(lines, ESMM_WIDTH["multi_hot_pad"])
        inst = [{k: batch[k][i] for k in card.signature["inputs"]} for i in range(64)]
        SR.reset_launches()
        got = card.score(inst)
        check(SR.expand_rows.launches >= 1, f"preset {name}: the scorer launched no expand_rows")
        want = cpu.score(inst)
        err = max(held_rel(f"preset {name} servable, card vs CPU scorer {k}", got[k], want[k], 2e-2)
                  for k in want)
        check(card.params["emb"].dtype == torch.float32, f"preset {name}: servable table dtype")
        log(f"preset {name}: the servable of the bf16 run (f32 tables) scored on 64 va lines, card "
            f"vs CPU max abs diff {err:.3e} (held at 2e-2)")
        del card, cpu
    torch.cuda.empty_cache()
    return res, launches, rate, peak


def presets_path(dev, work):
    """The four single-process presets: each through the CLI, then its
    bare step and wire (preset_bare); the kernels on the slim-decoded
    inputs. Returns ({preset: (cli result, launches, CLI ex/s, peak,
    preset_bare's numbers)}, card name filled in by the caller)."""
    t0 = time.perf_counter()
    out = {}
    for name in PRESET_WIDTH:
        res, launches, rate, peak = preset_cli(dev, work, name)
        out[name] = (res, launches, rate, peak, preset_bare(dev, work, name))
    slim_decoded_kernels(dev, out["esmm_large_vocab"][4].pop("kernel batch"),
                         out["din_large_vocab"][4].pop("kernel batch"))
    log(f"presets phase: {time.perf_counter() - t0:.1f} s")
    return out


def bf16_step_check(label, cfg, mapped, dev):
    """Each row update of 5 bf16 steps on the card against the same update
    on the CPU from the same inputs: the card's store before it, its
    gathered rows, ids and row gradients, and the same rounding noise
    (the CPU generator's state before the draw, drawn through the noise
    seam as in card_vs_cpu). Every store must come out equal but for
    elements one bf16 ulp apart (their count printed): the card's and
    the CPU's elementwise f32 math may differ in a last bit, which moves
    a rounding only where the noise lands there. (The whole steps differ
    by more: the row gradients' sums run in another order on the card,
    and an update that cancels to near zero, m = 0.9 m + 0.1 g, turns
    that round-off into several ulps; card_vs_cpu prints those.)"""
    model = create_model(cfg)
    (table,) = model.sparse_slots()
    p0, m0 = model.init(torch.Generator().manual_seed(3))
    tx = make_optimizer(cfg.optimizer, cfg.learning_rate)
    sopt = SP.make_sparse_row_optimizer(cfg.optimizer, cfg.learning_rate,
                                        fused_moments=cfg.fused_moments,
                                        fused_table=cfg.fused_table, catchup=cfg.sparse_catchup)
    step = SP.build_sparse_train_step(model, tx, sopt, lookup=SR.make_expand_lookup())
    params = SP.cast_tables(model, tree_map(lambda x: x.clone().to(dev), p0), torch.bfloat16)
    opt = SP.init_opt_state(model, tx, sopt, params)
    mstate = tree_map(lambda x: x.clone().to(dev), m0)
    sr = torch.Generator().manual_seed(11)
    apply, draw = sopt.apply, RD.sr_noise
    seen = {"apart": 0, "most": 0, "n": 0, "other": 0.0}

    def checked_apply(aux, su, u, g, generator=None):
        """The card's apply, then the CPU's on copies of its inputs."""
        cpu_aux = {k: v.cpu().clone() if isinstance(v, torch.Tensor) else v for k, v in aux.items()}
        cpu_sr = torch.Generator()
        cpu_sr.set_state(generator.get_state())
        out = apply(aux, su, u, g, generator)
        apply(cpu_aux, su.cpu(), u.cpu(), g.cpu(), cpu_sr)
        for k, v in cpu_aux.items():
            if not isinstance(v, torch.Tensor):
                continue
            got = aux[k].cpu()
            if v.dtype == torch.bfloat16:
                ulps = (got.view(torch.int16).int() - v.view(torch.int16).int()).abs()
                seen["apart"] += int((ulps > 0).sum())
                seen["most"] = max(seen["most"], int(ulps.max()))
                seen["n"] += ulps.numel()
            else:
                seen["other"] = max(seen["other"], float((got.double() - v.double()).abs().max()))
        return out

    sopt.apply = checked_apply
    RD.sr_noise = lambda shape, generator, device: draw(shape, generator, "cpu").to(device)
    try:
        for b in mapped:
            params, opt, mstate, loss = step(params, opt, mstate, to_device(b, dev), None, sr)
    finally:
        sopt.apply, RD.sr_noise = apply, draw
    log(f"bf16 row updates {label}, card vs CPU on the same inputs and noise, 5 steps: "
        f"{seen['apart']} of {seen['n']} bf16 store elements apart, at most {seen['most']} ulp; "
        f"other stores max diff {seen['other']:.3e}")
    check(seen["n"] > 0 and seen["most"] <= 1 and seen["other"] == 0.0,
          f"{label}: the row update on the card differs from the CPU's")


def bf16_trajectories(dev):
    """card_vs_cpu on bf16 stores with the noise replayed: ESMM on the
    fused store with catch-up (the esmm_large_vocab step: --mh_coo, no
    --dma_scatter) at B=512, vocab 50k, pad 64; DeepFM --fused_moments
    under Adam and FTRL at B=1,024; f32 towers; ReLU gates replayed."""
    cfg = Config(**dict(ESMM_WIDTH, feature_size=50_000, batch_size=512, multi_hot_pad=64,
                        compute_dtype="float32", param_dtype="bfloat16", dma_scatter=False,
                        sparse_catchup=True))
    chain = esmm_chain(create_model(cfg))
    mapped = [chain(b) for b in esmm_batches(5, seed=7, batch=512, vocab=50_000, pad=64)]
    card_vs_cpu("ESMM bf16 fused store, catch-up, B=512 vocab 50k pad 64", cfg, mapped, dev,
                lambda p: [p["ctr_out"]["w"], p["cvr_out"]["w"]], gates=True)
    bf16_step_check("ESMM bf16 fused store, catch-up", cfg, mapped, dev)
    cfg0 = Config(**dict(WIDTH, batch_size=1024, compute_dtype="float32", fused_table=False,
                         fused_moments=True, param_dtype="bfloat16"))
    mapper = SparseBatchMapper(create_model(cfg0).sparse_slots())
    mapped = [mapper(b) for b in zipf_batches(5, seed=7, batch=1024)]
    for opt in ("Adam", "ftrl"):
        card_vs_cpu(f"DeepFM --fused_moments {opt} bf16 B=1024", cfg0.replace(optimizer=opt),
                    mapped, dev, lambda p: [p["fm_b"], p["out"]["w"]], gates=True)
        bf16_step_check(f"DeepFM --fused_moments {opt}", cfg0.replace(optimizer=opt), mapped, dev)


# ------------------------------------------------------------- phase 6: the mesh
MESH_A = (2, 2)  # leg (a): DeepFM, data x model, four ranks on the one card
MESH_B = (1, 2)  # leg (b): ESMM, model sharding


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class CollectiveClock:
    """Host time spent in torch.distributed's all_reduce and broadcast
    while entered, with the card synchronised before and after each call,
    so that a collective's time is its own and not the queued work's."""

    def __init__(self, dev):
        self.dev, self.s, self.n = dev, 0.0, 0

    def __enter__(self):
        import torch.distributed as dist

        self._saved = (dist.all_reduce, dist.broadcast)

        def timed(fn):
            def call(*a, **kw):
                sync(self.dev)
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                sync(self.dev)
                self.s += time.perf_counter() - t0
                self.n += 1
                return out

            return call

        dist.all_reduce, dist.broadcast = (timed(f) for f in self._saved)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_reduce, dist.broadcast = self._saved


def mesh_kernels():
    return (SR.expand_rows, SR.accumulate_rows, CP.coo_pool_rows, CP.coo_accumulate_rows,
            RS.dma_row_scatter)


def mesh_bare_steps(h, n, check_store=False):
    """The rank's bare sharded step on two batches of its training input
    already on the card: n steps timed alone, then n with every
    collective timed (CollectiveClock). check_store: one step first, and
    the rank's store shard compared with its copy from before it: every
    row outside the step's uids in this shard bit-unchanged, the lanes
    past 3K and the spare row still 0."""
    ts = h.init_train_state()
    state = {k: ts[k] for k in ("params", "opt_state", "mstate")}
    step = h._get_train_step()
    it = iter(h._dataset("tr", shuffle=True, epochs=1))
    host = [next(it), next(it)]
    batches = [h._place(b) for b in host]
    gen = torch.Generator(device=h.device).manual_seed(1)
    sr = torch.Generator(device=h.device).manual_seed(2)
    state, _ = step(state, batches[0], gen, sr)
    out = {}
    if check_store:
        from tf_repos_tpu_torch.parallel.sparse_step import local_uids

        (t,) = h.model.sparse_slots()
        aux = state["opt_state"]["sparse"][t]
        store = aux["wmv"]
        before = store.clone()
        vl = store.shape[0] - 1
        u = batches[1][UIDS_PREFIX + t]
        u_loc = local_uids(u, h.model.sparse_slots()[t].vocab, vl, h.mesh.m)
        state, _ = step(state, batches[1], gen, sr)
        sync(h.device)
        keep = torch.ones(vl + 1, dtype=torch.bool, device=store.device)
        keep[u_loc[u_loc < vl].long()] = False
        k3 = 3 * aux["k"]
        out["untouched_equal"] = bool(torch.equal(store[keep], before[keep]))
        out["touched_rows"] = int((~keep).sum())
        out["pad_lanes_zero"] = bool((store[:, k3:] == 0).all())
        out["spare_zero"] = bool((store[-1] == 0).all())
        out["pad_rows"] = int(max(0, (h.mesh.m + 1) * vl - h.model.sparse_slots()[t].vocab))
        del before
    sync(h.device)
    h.mesh.barrier()
    t0 = time.perf_counter()
    for i in range(n):
        state, loss = step(state, batches[i % 2], gen, sr)
    sync(h.device)
    out["step_ms"] = (time.perf_counter() - t0) / n * 1e3
    h.mesh.barrier()
    with CollectiveClock(h.device) as clock:
        t0 = time.perf_counter()
        for i in range(n):
            state, loss = step(state, batches[i % 2], gen, sr)
        sync(h.device)
        out["clocked_step_ms"] = (time.perf_counter() - t0) / n * 1e3
    out["collective_ms"] = clock.s / n * 1e3
    out["collectives"] = clock.n / n
    return out


def mesh_rank(mesh, argv, n_bare, check_store, coo=False):
    """Rank program of legs (a) and (b) of phases 6 and 7: the harness's
    train task on this rank (launch counters zeroed just before, read
    just after, every rank's counts summed into a [ranks, kernels]
    table), then the bare step timed (mesh_bare_steps); under ``coo``
    (several hosts) each batch's own and cross-host COO bucket."""
    import torch.distributed as dist

    for mod in (SR, CP, RS):
        mod.reset_launches()
    h = Harness(parse_config(argv), mesh)
    widths = None
    if coo:
        widths = h._uids_union = CooWidths(h._uids_union)
    t0 = time.perf_counter()
    res = h.train()
    sync(mesh.device)
    wall = time.perf_counter() - t0
    counts = torch.zeros(mesh.size, len(mesh_kernels()), dtype=torch.int64)
    counts[mesh.rank] = torch.tensor([f.launches for f in mesh_kernels()])
    dist.all_reduce(counts)
    bare = mesh_bare_steps(h, 5, check_store)
    for mod in (SR, CP, RS):
        mod.reset_launches()
    peak = torch.cuda.max_memory_allocated(mesh.device) if mesh.device.type == "cuda" else 0
    return {"res": res, "wall": wall, "counts": counts.tolist(), "bare": bare,
            "backend": mesh.backend, "peak": peak, "host": mesh.host,
            "coo": None if widths is None else (widths.own, widths.agreed)}


def nccl_rank(mesh, width, n_steps):
    """Leg (d) on a one-rank NCCL group: the sharded lazy step at mesh 1x1
    through parallel/sparse_step.py beside the single-device step
    (train/sparse.py), from one init on the DeepFM point's batches;
    ShardedSparseState's shard and assemble round trip (bit-exact) and its
    assemble after the steps on the card; and an NCCL all-reduce and
    broadcast of a tensor on the card. At 1x1 the step and assemble call
    no collective (Mesh skips a group of one): those two are the leg's
    only NCCL calls."""
    import torch.distributed as dist

    from tf_repos_tpu_torch.parallel.sparse_step import (
        ShardedSparseState,
        build_sharded_sparse_train_step,
    )

    dev = mesh.device
    cfg = Config(**width)
    model = create_model(cfg)
    tx = make_optimizer(cfg.optimizer, cfg.learning_rate)
    mapper = SparseBatchMapper(model.sparse_slots())
    batches = [to_device(mapper(b), dev)
               for b in zipf_batches(n_steps, seed=21, batch=cfg.batch_size, vocab=cfg.feature_size)]
    runs = {}
    for kind in ("single", "sharded"):
        sopt = SP.make_sparse_row_optimizer("Adam", cfg.learning_rate, fused_table=True)
        params, mstate = model.init(torch.Generator().manual_seed(4))
        params = tree_map(lambda t: t.to(dev), params)
        mstate = tree_map(lambda t: t.to(dev), mstate)
        opt = SP.init_opt_state(model, tx, sopt, params)
        if kind == "single":
            step = SP.build_sparse_train_step(model, tx, sopt, lookup=SR.make_expand_lookup())
        else:
            init = opt["sparse"]["fm_wv"]["wmv"].clone()
            sharder = ShardedSparseState(model, sopt, mesh)
            st = sharder.shard({"params": params, "opt_state": opt, "mstate": mstate})
            params, opt, mstate = st["params"], st["opt_state"], st["mstate"]
            # shard, then assemble: the single-device store bit for bit
            round_trip = torch.equal(sharder.assemble(st)["opt_state"]["sparse"]["fm_wv"]["wmv"],
                                     init)
            del init
            step = build_sharded_sparse_train_step(
                model, tx, sopt, mesh, {t: s.vocab for t, s in model.sparse_slots().items()},
                inner_lookup=SR.make_expand_lookup())
        losses = []
        for b in batches:
            params, opt, mstate, loss = step(params, opt, mstate, b)
            losses.append(float(loss))
        if kind == "sharded":
            # the assembled store (gather_rows' device branch under NCCL):
            # the shard's V real rows bit for bit, on the card, spare row 0
            whole = sharder.assemble({"params": params, "opt_state": opt, "mstate": mstate})
            ws = whole["opt_state"]["sparse"]["fm_wv"]["wmv"]
            shard = opt["sparse"]["fm_wv"]["wmv"]
            assembled = (ws.device == shard.device and torch.equal(ws[:-1], shard[: cfg.feature_size])
                         and bool((ws[-1] == 0).all()))
        # the 1x1 shard is padded to pad_vocab(V, 1) rows: compare the V real ones
        runs[kind] = (losses, opt["sparse"]["fm_wv"]["wmv"][: cfg.feature_size].clone())
    x = torch.arange(8, dtype=torch.float32, device=dev)
    y = x.clone()
    dist.all_reduce(y)
    dist.broadcast(y, src=0)
    sync(dev)
    (l1, w1), (l2, w2) = runs["single"], runs["sharded"]
    return {"backend": mesh.backend, "losses": (l1, l2), "round_trip": round_trip,
            "assembled": assembled, "store_max_abs": float((w1 - w2).abs().max()),
            "collective_ok": bool(torch.equal(x, y))}


def train_losses(model_dir):
    with open(os.path.join(model_dir, "smoke", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], r["loss"]) for r in recs if r["kind"] == "train"]


def held_losses(label, got, want):
    check([s for s, _ in got] == [s for s, _ in want], f"{label}: logged steps {got} vs {want}")
    a, b = np.array([v for _, v in got]), np.array([v for _, v in want])
    err = np.abs(a - b)
    check(bool((err <= 2e-5 + 2e-4 * np.abs(b)).all()),
          f"{label}: mesh losses {a.tolist()} vs single-device {b.tolist()}")
    return float((err / np.abs(b)).max())


def mesh_rank_line(label, out, steps, card):
    bare = out["bare"]
    share = bare["collective_ms"] / bare["clocked_step_ms"]
    log(f"{label} on {out['backend']} ({card}): bare step {bare['step_ms']:.2f} ms a rank "
        f"({bare['clocked_step_ms']:.2f} ms with each collective synchronised and timed); "
        f"collectives {bare['collective_ms']:.2f} ms a step in {bare['collectives']:.0f} calls = "
        f"{share:.3f} of the step; CLI {steps} steps in {out['wall']:.1f} s wall; peak device "
        f"memory rank 0 {out['peak'] / 2**30:.2f} GiB")
    return share


def mesh_launches(label, out, steps, once, some=()):
    """Every rank's count of each kernel the leg runs: those of ``once``
    one a step, those of ``some`` at least once; alike on every rank."""
    per = {}
    for i, f in enumerate(mesh_kernels()):
        if f.__name__ not in once + some:
            continue
        col = [row[i] for row in out["counts"]]
        ok = all(c == steps for c in col) if f.__name__ in once else col[0] > 0
        check(ok and len(set(col)) == 1,
              f"{label}: {f.__name__} launched {col} times on the ranks in {steps} steps")
        per[f.__name__] = col[0]
    log(f"{label}: launches per rank {per} in {steps} steps (all ranks alike)")
    return per


def mesh_kernel_phase(dev):
    """K1 and K2 at a 2x2 mesh rank's shapes (the rank's B/2 = 8,192 rows
    of the DeepFM point's batch over the global working set, as
    k1_k2_point holds and times them), and K7 at the 1x2 mesh rank's
    store shard of the ESMM point: the [V/2 + 1, 128] store, the global
    uids mapped to the shard (parallel/sparse_step.local_uids: other
    shards' rows and the sentinel to the spare row, dropped by n_valid),
    bit-exact against the masked assignment, timed against index_copy_ of
    the shard's rows."""
    from tf_repos_tpu_torch.ops.embedding import pad_vocab
    from tf_repos_tpu_torch.parallel.sparse_step import local_uids

    out = {"t": {}, "bound": {}, "bound_by": {}, "err": {}}
    pt = deepfm_point(dev)
    d, _ = MESH_A
    rows = B // d
    idx = pt["idx"].view(B, -1)[:rows].reshape(-1).contiguous()
    k1_k2_point(out, "2x2 mesh rank", f"DeepFM's lookup on a rank's {rows} rows", pt["su"],
                pt["k"], idx, pt["s"], pt["gen"])
    model = create_model(Config(**ESMM_WIDTH))
    vocab = ESMM_WIDTH["feature_size"]
    u = torch.from_numpy(esmm_chain(model)(esmm_batches(1)[0])["__uids_emb"]).to(dev)
    vl = pad_vocab(vocab, MESH_B[1]) // MESH_B[1]
    u_loc = local_uids(u, vocab, vl, 0)
    kept = int((u_loc < vl).sum())
    k3 = 3 * ESMM_WIDTH["embedding_size"]
    gen = torch.Generator(device=dev).manual_seed(6)
    store = torch.randn((vl + 1, 128), generator=gen, device=dev)
    store[-1] = 0.0
    rows3 = torch.randn((u.shape[0], k3), generator=gen, device=dev)
    want = RS.dma_row_scatter_plain(store[:, :k3].clone(), u_loc, rows3, vl)
    RS.dma_row_scatter(store[:, :k3], u_loc, rows3, n_valid=vl)
    sync(dev)
    check(torch.equal(store[:, :k3], want), "dma_row_scatter on the 1x2 mesh rank's shard differs "
                                            "from the masked assignment")
    del want
    keep = u_loc < vl
    u_live, r_live = u_loc[keep].long(), rows3[keep].contiguous()
    view = store[:, :k3]
    e = "dma_row_scatter (1x2 mesh rank)"
    out["t"][e] = (cuda_ms(lambda: RS.dma_row_scatter(view, u_loc, rows3, n_valid=vl)),
                   cuda_ms(lambda: RS.dma_row_scatter_plain(view, u_loc, rows3, vl), iters=10),
                   cuda_ms(lambda: view.index_copy_(0, u_live, r_live)))
    # least time: the shard's rows read and written once, the uids read
    nbytes = 2 * kept * k3 * 4 + u.shape[0] * 4
    out["bound"][e], out["bound_by"][e], out["err"][e] = nbytes / HBM_BYTES_PER_S * 1e3, "bytes", 0.0
    ms, plain, lib = out["t"][e]
    log(f"kernel {e}: store shard [{vl + 1}, 128] f32 (the step writes its {k3} live lanes), "
        f"S={u.shape[0]}, {kept} uids in the shard: bit-exact  {ms:.4f} ms  plain {plain:.4f} ms  "
        f"library (index_copy_) {lib:.4f} ms  bound {out['bound'][e]:.4f} ms "
        f"({out['bound'][e] / ms:.2f} of it)")
    del store, rows3, r_live
    torch.cuda.empty_cache()
    return out


def poisoned_cli(dev, work):
    """--check_numerics on the card: a DeepFM CLI run whose third training
    line holds a feature value of 1e39 (inf in f32; the FM's inf - inf
    makes the NaN). The CLI must exit nonzero with FloatingPointError."""
    data = os.path.join(work, "nan_data")
    os.makedirs(data)
    write_synthetic_libsvm(os.path.join(data, "tr.libsvm"), 96, 400, seed=0)
    p = os.path.join(data, "tr.libsvm")
    with open(p) as f:
        lines = f.read().splitlines()
    head, rest = lines[2].split(" ", 1)
    parts = rest.split(" ")
    parts[14] = parts[14].split(":")[0] + ":1e39"
    lines[2] = " ".join([head, *parts])
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
    r = subprocess.run(
        [sys.executable, "-m", "tf_repos_tpu_torch.main", "--model=DeepFM", "--feature_size=400",
         "--field_size=39", "--embedding_size=4", "--deep_layers=8,4", "--batch_size=32",
         "--num_epochs=1", f"--data_dir={data}", f"--model_dir={work}/nan_model/",
         "--eval_throttle_secs=0", "--check_numerics=true", f"--device={dev.type}"],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    check(r.returncode != 0 and "FloatingPointError" in r.stderr,
          f"--check_numerics on a poisoned run: rc {r.returncode}, stderr {r.stderr[-2000:]}")
    log(f"--check_numerics on the card: the poisoned DeepFM run exits {r.returncode} with "
        f"{[l for l in r.stderr.splitlines() if 'FloatingPointError' in l][-1].strip()}")


def profile_cli(dev, work, card):
    """--profile_steps=2 on the single-device DeepFM CLI at the benchmark
    point, a process of its own (this one's later torch.profiler counts
    stay as they were): the trace under <model_dir>/profile must name the
    hand-written K1 and K2 kernels (their CUDA function names) and the
    port's step spans and input wait, and the run logs the spans' device
    ms a step."""
    argv = [f"--{k}={v}" for k, v in WIDTH.items()] + [
        "--task_type=train", "--num_epochs=1", "--log_steps=7", f"--data_dir={work}/data",
        f"--model_dir={work}/profiled/", "--dt_dir=smoke", "--eval_throttle_secs=0",
        f"--device={dev.type}", "--seed=2018", "--profile_steps=2", "--profile_start_step=3"]
    r = subprocess.run([sys.executable, "-m", "tf_repos_tpu_torch.main", *argv], cwd=HERE,
                       capture_output=True, text=True, timeout=600)
    check(r.returncode == 0, f"--profile_steps CLI run: rc {r.returncode}, {r.stderr[-2000:]}")
    traces = [os.path.join(r, f) for r, _, fs in os.walk(f"{work}/profiled/smoke/profile")
              for f in fs if f.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"--profile_steps wrote {traces}")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    for name in ("expand_rows_kernel", "accumulate_rows_kernel"):
        n = sum(name in k for k in kernels)
        check(n >= 2, f"the --profile_steps trace names {name} {n} times in 2 steps")
    # the port's spans over them, and the host input's wait
    names = {e.get("name", "") for e in events}
    for name in ("step.forward", "step.backward", "step.update", "input.wait"):
        check(name in names, f"the --profile_steps trace has no {name} span")
    spans = [ln for ln in r.stdout.splitlines() if ln.startswith("INFO: spans")]
    check(len(spans) == 1, f"--profile_steps logged {len(spans)} span lines")
    log(spans[0])
    log(f"--profile_steps=2 on {card}: {os.path.basename(traces[0])}, {len(kernels)} kernel "
        f"events, expand_rows_kernel x{sum('expand_rows_kernel' in k for k in kernels)}, "
        f"accumulate_rows_kernel x{sum('accumulate_rows_kernel' in k for k in kernels)}")


def mesh_phase(dev, work, card):
    """Phase 6, the mesh (parallel/): legs (a) DeepFM on a 2x2 mesh, four
    ranks on the one card (gloo), the whole DeepFM main path epoch through
    the harness, its per-step losses held to the single-device run's from
    the same init and batches (rtol 2e-4, atol 2e-5: the JAX package's
    sharded-vs-single bar), K1 and K2 once a step on every rank; (b) ESMM
    at the published point on a 1x2 mesh (each rank half of the
    lane-padded [4,500,000, 128] store), its logged losses held to the
    single-device ESMM run on the same cache, K1-K4 and K7 once a step on
    every rank, and the store shard bit-unchanged outside a step's uids;
    (c) leg (a)'s checkpoint evaluated on one device equal to the mesh's
    own final eval; (d) a one-rank NCCL group running the sharded lazy
    step at 1x1 equal to the single-device step; (e) --profile_steps and
    --check_numerics through the CLI. Then K1/K2 at the 2x2 rank's shapes
    and K7 on the 1x2 rank's shard against their plain versions."""
    from tf_repos_tpu_torch.parallel.launch import run_on_mesh

    t_all = time.perf_counter()
    res = {}
    # (a) one-device reference, then the mesh, on the main path's files
    base = [f"--{k}={v}" for k, v in WIDTH.items()] + [
        "--task_type=train", "--num_epochs=1", "--log_steps=1", f"--data_dir={work}/data",
        "--dt_dir=smoke", "--eval_throttle_secs=0", "--seed=2018"]
    ref = cli.main([*base, f"--model_dir={work}/mesh_ref/", f"--device={dev.type}"])
    d, m = MESH_A
    argv = [*base, f"--model_dir={work}/mesh_a/", f"--mesh_data={d}", f"--mesh_model={m}"]
    out = run_on_mesh(mesh_rank, (argv, 5, False), data=d, model=m, devices=[dev] * (d * m))
    steps = out["res"]["step"]
    check(steps == ref["step"] >= 10, f"leg (a) ran {steps} steps, the reference {ref['step']}")
    rel = held_losses("leg (a) 2x2 DeepFM", train_losses(f"{work}/mesh_a"),
                      train_losses(f"{work}/mesh_ref"))
    res["a"] = dict(out, launches=mesh_launches("leg (a)", out, steps,
                                                ("expand_rows", "accumulate_rows")), steps=steps)
    res["a"]["share"] = mesh_rank_line(f"leg (a) DeepFM {d}x{m}, B={B} ({B // d} a rank)", out,
                                       steps, card)
    log(f"leg (a): {steps} steps' losses within {rel:.2e} relative of the single-device run's; "
        f"eval loss {out['res']['loss']:.7f} vs {ref['loss']:.7f}, auc {out['res']['auc']:.7f} vs "
        f"{ref['auc']:.7f}")
    # (c) the mesh's checkpoint on one device
    one = cli.main([*base, f"--model_dir={work}/mesh_a/", f"--device={dev.type}",
                    "--task_type=eval", "--mesh_data=1", "--mesh_model=1"])
    for k in ("loss", "auc"):
        check(abs(one[k] - out["res"][k]) <= 2e-5 + 2e-4 * abs(out["res"][k]),
              f"leg (c): the 2x2 checkpoint's {k} on one device {one[k]} vs the mesh's eval "
              f"{out['res'][k]}")
    log(f"leg (c): the 2x2 mesh's checkpoint evaluated on one device: loss {one['loss']:.7f} "
        f"auc {one['auc']:.7f} (mesh {out['res']['loss']:.7f} / {out['res']['auc']:.7f})")

    # (b) ESMM on the ESMM main path's cache, beside its single-device run
    d, m = MESH_B
    eargv = [f"--{k}={v}" for k, v in ESMM_WIDTH.items()] + [
        "--task_type=train", "--num_epochs=1", "--log_steps=5", f"--data_dir={work}/esmm_data",
        "--dt_dir=smoke", "--eval_throttle_secs=0", "--seed=2018", "--map_workers=2",
        "--packed_cache=true", f"--model_dir={work}/mesh_b/", f"--mesh_data={d}",
        f"--mesh_model={m}"]
    out = run_on_mesh(mesh_rank, (eargv, 5, True), data=d, model=m, devices=[dev] * (d * m))
    steps = out["res"]["step"]
    rel = held_losses("leg (b) 1x2 ESMM", train_losses(f"{work}/mesh_b"),
                      train_losses(f"{work}/esmm_hit"))
    res["b"] = dict(out, launches=mesh_launches(
        "leg (b)", out, steps, ("accumulate_rows", "coo_accumulate_rows", "dma_row_scatter"),
        ("expand_rows", "coo_pool_rows")), steps=steps)
    bare = out["bare"]
    check(bare["untouched_equal"] and bare["pad_lanes_zero"] and bare["spare_zero"],
          f"leg (b): store shard after a step: {bare}")
    res["b"]["share"] = mesh_rank_line(f"leg (b) ESMM {d}x{m}, B={EB}", out, steps, card)
    log(f"leg (b): logged losses within {rel:.2e} relative of the single-device run's; rank 0's "
        f"store shard after one more step: {bare['touched_rows']} rows written, every other row "
        f"bit-unchanged, lanes past 3K and the spare row 0, {bare['pad_rows']} pad_vocab rows "
        f"in the shard")

    # (d) NCCL, one rank
    out = run_on_mesh(nccl_rank, (WIDTH, 3), data=1, model=1, devices=[dev])
    check(out["backend"] == "nccl" and out["collective_ok"] and out["round_trip"]
          and out["assembled"], f"leg (d): {out}")
    (l1, l2) = out["losses"]
    lrel = max(abs(a - b) / abs(a) for a, b in zip(l1, l2))
    # K2's atomics sum in another order on each run: the stores are held
    # as the card-vs-CPU trajectories hold theirs (1e-4, a fifth of one
    # Adam step at lr 5e-4)
    check(lrel <= 1e-6 and out["store_max_abs"] <= 1e-4,
          f"leg (d): the 1x1 sharded step vs the single-device step: losses {l1} vs {l2}, store "
          f"max abs diff {out['store_max_abs']}")
    log(f"leg (d): one-rank NCCL group, the 1x1 sharded step vs the single-device step, 3 steps: "
        f"losses within {lrel:.2e} relative, w|m|v store within {out['store_max_abs']:.2e}; "
        f"ShardedSparseState.shard then assemble bit-exact to the single-device store, and "
        f"assemble after the steps bit-exact to the shard on the card; an NCCL all_reduce and "
        f"broadcast on the card (at 1x1 the step itself calls no collective)")

    # (e) observability through the CLI
    profile_cli(dev, work, card)
    poisoned_cli(dev, work)
    log(f"mesh phase: {time.perf_counter() - t_all:.1f} s")
    res["kernels"] = mesh_kernel_phase(dev)
    return res



# ------------------------------------------------------------------ phase 7
MH_HOSTS = 2
MH_STEPS = 16  # leg (a): steps on each host's file
MH_ESMM_STEPS = 8  # leg (b)
MH_SLIM_STEPS = 5  # leg (d)
MH_INFER_ROWS = (3 * B, 5000)  # leg (c): te files of unequal length (3 batches and 1)
# leg (e): the Criteo surrogate (data/criteo_surrogate.py) through the
# preprocessor (features/criteo.py) into DeepFM's dense step on
# --field_blocks=auto:<feature_map>
SURR_TRAIN, SURR_TEST = 300_000, 50_000
SURR_WIDTH = dict(FB_WIDTH, batch_size=2048, learning_rate=0.001)
SURR_AUC_BAR = 0.70  # eval AUC after one epoch (PERF.md, written before the first run)


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def split_lines(src, parts):
    """Write each (path, first line, end line) slice of the text file src."""
    with open(src) as f:
        lines = f.readlines()
    for path, lo, hi in parts:
        check(hi <= len(lines), f"{src} has {len(lines)} lines, {path} needs {hi}")
        with open(path, "w") as f:
            f.writelines(lines[lo:hi])


def host_entry(spec: str, task: int) -> None:
    """One host of a phase-7 leg, a process of its own: its ranks of the
    mesh over the hosts (parallel/launch.run_on_hosts), every rank on the
    one card; the first local rank's result pickled beside ``spec``."""
    import pickle

    from tf_repos_tpu_torch.parallel.launch import run_on_hosts

    with open(spec, "rb") as f:
        fn, args, data, model, hosts, dev = pickle.load(f)
    out = run_on_hosts(globals()[fn], args, data=data, model=model,
                       devices=[dev] * (data * model // len(hosts)), hosts=hosts,
                       task_index=task, timeout=900)
    with open(f"{spec}.{task}", "wb") as f:
        pickle.dump(out, f)


def run_two_hosts(work, tag, fn, args, data, model, dev):
    """Two host processes on 127.0.0.1 (free ports; the first the
    coordinator), each running ``fn(mesh, *args)`` on its ranks: (stdout,
    result) of each host. A host that fails or outlives 900 s fails the
    leg, and both are killed with their ranks."""
    import pickle

    spec = os.path.join(work, f"hosts_{tag}.pkl")
    hosts = [f"127.0.0.1:{free_port()}" for _ in range(MH_HOSTS)]
    with open(spec, "wb") as f:
        pickle.dump((fn.__name__, args, data, model, hosts, str(dev)), f)
    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.host_entry({spec!r}, {i})"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for i in range(MH_HOSTS)]
    outs = []
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(timeout=900)
            check(p.returncode == 0, f"{tag}: host {i} exited {p.returncode}: {err[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:  # a host and its ranks
            stop_group(p)
    results = []
    for i in range(MH_HOSTS):
        with open(f"{spec}.{i}", "rb") as f:
            results.append(pickle.load(f))
    return outs, results


class CooWidths:
    """Wraps a harness's GlobalUidsUnion: the COO bucket of each batch on
    this host before the union and the cross-host one after."""

    def __init__(self, union):
        self.union, self.own, self.agreed = union, [], []

    def __call__(self, batch):
        self.own.append(int(batch[MHC_IDX].shape[-1]))
        out = self.union(batch)
        self.agreed.append(int(out[MHC_IDX].shape[-1]))
        return out


def multihost_task(mesh, argv):
    """A CLI task on this rank (eval, infer): the harness's own entry."""
    from tf_repos_tpu_torch.train.harness import run_task_on_mesh

    return run_task_on_mesh(mesh, parse_config(argv))


def single_device_reference(dev, argv, steps, chain):
    """The single-device step (the same harness flags, one process, from the
    same seeded init) on the legs' global batches: each host's batches as
    its ranks read them (its file shard, shuffled by --seed), host 0's
    rows then host 1's, through ``chain`` (the host map). (losses, the
    final row store)."""
    from tf_repos_tpu_torch.data.pipeline import shard_files_for_host
    from tf_repos_tpu_torch.models import input_format
    from tf_repos_tpu_torch.parallel.step import fold_seed

    h = Harness(parse_config([*argv, f"--device={dev.type}", "--mesh_data=1", "--mesh_model=1"]))
    files = h._glob_split("tr", shuffle=True)
    fmt = input_format(h.model)
    its = [iter(h._build_reader(shard_files_for_host(files, i, MH_HOSTS), fmt, shuffle=True,
                                epochs=1)) for i in range(MH_HOSTS)]
    ts = h.init_train_state()
    state = {k: ts[k] for k in ("params", "opt_state", "mstate")}
    step = h._get_train_step()
    gen = torch.Generator(device=dev).manual_seed(fold_seed(h.cfg.seed + 1, 0))
    sr = torch.Generator(device=dev).manual_seed(h.cfg.seed + 2)
    losses = []
    for _ in range(steps):
        parts = [next(it) for it in its]
        g = chain({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
        state, loss = step(state, to_device(g, dev), gen, sr)
        losses.append(float(loss))
    (t,) = h.model.sparse_slots()
    store = state["opt_state"]["sparse"][t]["wmv"]
    return losses, store[: h.model.sparse_slots()[t].vocab].cpu()


def checkpoint_store(model_dir, table):
    from tf_repos_tpu_torch.train.checkpoint import CheckpointManager

    st = CheckpointManager(os.path.join(model_dir, "smoke")).restore("cpu")
    store = st["opt_state"]["sparse"][table]["wmv"]
    return store[:-1]


def held_store(label, got, want, k, lr, steps, mv_bar=1e-4):
    """The fused w|m|v store of a mesh run against the single-device
    run's. m and v are held at ``mv_bar`` (the gradients agree to
    round-off; None: printed only). w is held at 1e-4 but for the
    elements Adam moved on a gradient that cancels to ~0, whose
    round-off (another summation order over "data", K2's atomics)
    decides the update's sign: each such element differs by at most
    ``steps`` updates of lr, and they are counted and printed. Returns
    the max abs difference of w."""
    d = (got[:, : 3 * k] - want[:, : 3 * k]).abs()
    dw, dm, dv = (float(d[:, i * k:(i + 1) * k].max()) for i in range(3))
    over = int((d[:, :k] > 1e-4).sum())
    log(f"{label}: store max abs difference w {dw:.2e} ({over} of {d[:, :k].numel()} elements "
        f"over 1e-4), m {dm:.2e}, v {dv:.2e}")
    check((mv_bar is None or (dm <= mv_bar and dv <= mv_bar)) and dw <= steps * lr * 1.01,
          f"{label}: the store differs from the single-device run's: w {dw}, m {dm}, v {dv}")
    return dw


def consensus_point(dev):
    """K1/K2 at a two-host 2x2 rank's shapes (its host's 16,384 rows over
    the global working set of both hosts' batches: the union of two
    DeepFM-point batches), and K3/K4 at a two-host ESMM rank's (one host
    batch's COO re-padded to the cross-host bucket, over the global
    uids) with K7 writing those uids into the whole [V+1, 128] store
    (model axis 1). The union runs as on two hosts: two threads, one
    GlobalUidsUnion each, meeting in a thread all-gather."""
    import threading

    from tf_repos_tpu_torch.data.sparse_batch import GlobalUidsUnion

    def two_host_union(slots, hosts):
        barrier = threading.Barrier(2)
        box = [None, None]
        out = [None, None]

        def run(i):
            def gather(x):
                box[i] = np.array(x)
                barrier.wait()
                got = np.stack([box[0], box[1]])
                barrier.wait()
                return got

            out[i] = GlobalUidsUnion(slots, allgather=gather)(hosts[i])

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return out

    res = {"t": {}, "bound": {}, "bound_by": {}, "err": {}}
    model = create_model(Config(**WIDTH))
    mapper = SparseBatchMapper(model.sparse_slots())
    hosts = [mapper(b) for b in zipf_batches(2, seed=31)]
    u0, _ = two_host_union(model.sparse_slots(), hosts)
    s = int(u0["__uids_fm_wv"].shape[0])
    idx = torch.from_numpy(np.ascontiguousarray(u0["feat_ids"][:, STATIC:]).reshape(-1)).to(dev)
    k = 1 + WIDTH["embedding_size"]
    gen = torch.Generator(device=dev).manual_seed(32)
    su = torch.randn((s, 3 * k), generator=gen, device=dev)
    k1_k2_point(res, "two-host 2x2 rank", f"DeepFM's lookup on a rank's {B} rows over both "
                f"hosts' uids", su, k, idx, s, gen)

    emodel = create_model(Config(**ESMM_WIDTH))
    packer = MhCooPacker(emodel.mh_coo_groups(), combine=True)
    emapper = SparseBatchMapper(emodel.sparse_slots())
    ehosts = [emapper(packer(dict(b))) for b in esmm_batches(2, seed=33)]
    own = [int(b[MHC_IDX].shape[-1]) for b in ehosts]
    e0, _ = two_host_union(emodel.sparse_slots(), ehosts)
    idx3, dest3, w3 = (torch.from_numpy(np.ascontiguousarray(e0[key][0])).to(dev)
                       for key in (MHC_IDX, MHC_DEST, MHC_W))
    m, es, ek = idx3.shape[0], int(e0["__uids_emb"].shape[0]), ESMM_WIDTH["embedding_size"]
    g3 = EB * len(emodel.mh_coo_groups())
    store = torch.randn((es, 3 * ek), generator=gen, device=dev)
    table, dp = store[:, :ek], torch.randn((g3, ek), generator=gen, device=dev)
    err3 = held("coo_pool_rows (two-host rank)", CP.coo_pool_rows(table, idx3, dest3, w3, g3),
                CP.coo_pool_rows_plain(table, idx3, dest3, w3, g3),
                CP.coo_pool_rows_plain(table.abs(), idx3, dest3, w3.abs(), g3))
    err4 = held("coo_accumulate_rows (two-host rank)",
                CP.coo_accumulate_rows(dp, idx3, dest3, w3, es),
                CP.coo_accumulate_rows_plain(dp, idx3, dest3, w3, es),
                CP.coo_accumulate_rows_plain(dp.abs(), idx3, dest3, w3.abs(), es))
    tc, idx64 = table.contiguous(), idx3.long()
    cnt = torch.from_numpy(e0[MHC_CNT].reshape(-1).astype(np.int64))
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64), torch.cumsum(cnt, 0)[:-1]]).to(dev)
    n_live = int(cnt.sum())
    zeros = torch.zeros((es, ek), device=dev)
    e3, e4 = "coo_pool_rows (two-host rank)", "coo_accumulate_rows (two-host rank)"
    res["t"][e3] = (cuda_ms(lambda: CP.coo_pool_rows(table, idx3, dest3, w3, g3)),
                    cuda_ms(lambda: CP.coo_pool_rows_plain(table, idx3, dest3, w3, g3)),
                    cuda_ms(lambda: torch.nn.functional.embedding_bag(
                        idx64[:n_live], tc, offsets, mode="sum", per_sample_weights=w3[:n_live])))
    res["t"][e4] = (cuda_ms(lambda: CP.coo_accumulate_rows(dp, idx3, dest3, w3, es)),
                    cuda_ms(lambda: CP.coo_accumulate_rows_plain(dp, idx3, dest3, w3, es)),
                    cuda_ms(lambda: torch.index_add(zeros, 0, idx3,
                                                    dp.index_select(0, dest3) * w3[:, None])))
    nbytes = m * 12 + es * ek * 4 + g3 * ek * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, 2 * m * ek / F32_FLOPS * 1e3
    for e, err in ((e3, err3), (e4, err4)):
        res["bound"][e] = max(t_bytes, t_ops)
        res["bound_by"][e] = "bytes" if t_bytes >= t_ops else "operations"
        res["err"][e] = err
        ms, plain, lib = res["t"][e]
        log(f"kernel {e}: host 0's {EB} rows, COO bucket {m} (the hosts' own {own}), "
            f"{n_live} live slots, global S={es}: max_abs_err {err:.3e}  {ms:.4f} ms  plain "
            f"{plain:.4f} ms  library {lib:.4f} ms  bound {res['bound'][e]:.4f} ms "
            f"({res['bound_by'][e]}; {res['bound'][e] / ms:.2f} of it)")
    del store, table, dp, zeros
    vocab = ESMM_WIDTH["feature_size"]
    u = torch.from_numpy(e0["__uids_emb"]).to(dev)
    live = int((e0["__uids_emb"] < vocab).sum())
    big = torch.randn((vocab + 1, 128), generator=gen, device=dev)
    big[-1] = 0.0
    k3 = 3 * ek
    rows = torch.randn((es, k3), generator=gen, device=dev)
    view = big[:, :k3]
    want = RS.dma_row_scatter_plain(view.clone(), u, rows, vocab)
    RS.dma_row_scatter(view, u, rows, n_valid=vocab)
    sync(dev)
    check(torch.equal(view, want), "dma_row_scatter (two-host rank) differs from the masked "
                                   "assignment")
    del want
    u_live, r_live = u[:live].long(), rows[:live].contiguous()
    e7 = "dma_row_scatter (two-host rank)"
    res["t"][e7] = (cuda_ms(lambda: RS.dma_row_scatter(view, u, rows, n_valid=vocab)),
                    cuda_ms(lambda: RS.dma_row_scatter_plain(view, u, rows, vocab), iters=10),
                    cuda_ms(lambda: view.index_copy_(0, u_live, r_live)))
    nbytes = 2 * live * k3 * 4 + es * 4
    res["bound"][e7], res["bound_by"][e7], res["err"][e7] = nbytes / HBM_BYTES_PER_S * 1e3, "bytes", 0.0
    ms, plain, lib = res["t"][e7]
    log(f"kernel {e7}: store [{vocab + 1}, 128] f32 ({k3} live lanes), the global S={es} "
        f"({live} live): bit-exact  {ms:.4f} ms  plain {plain:.4f} ms  library (index_copy_) "
        f"{lib:.4f} ms  bound {res['bound'][e7]:.4f} ms ({res['bound'][e7] / ms:.2f} of it)")
    del big, rows, r_live
    torch.cuda.empty_cache()
    return res


def surrogate_data(work, train_lines, test_lines) -> None:
    """Leg (e)'s host side, a process of its own (surrogate_process): the
    port's surrogate writes SURR_TRAIN train lines (worker processes over
    the host's cores, while this process solves the same label
    calibration for the test lines and the Bayes ceiling) and SURR_TEST
    test lines; the port's preprocessor turns them into libsvm and a
    feature_map. What it measured goes to <work>/surrogate.json."""
    import threading

    from tf_repos_tpu_torch.data import criteo_surrogate as CSG
    from tf_repos_tpu_torch.features import criteo as FC

    raw, data = os.path.join(work, "surrogate_raw"), os.path.join(work, "surrogate")
    os.makedirs(raw)
    cores = max(1, (os.cpu_count() or 2) - 1)
    t0 = time.perf_counter()
    CSG.configure(train_lines)
    shard_stats = {}
    writer = threading.Thread(target=lambda: shard_stats.update(CSG.generate_raw_sharded(
        os.path.join(raw, "train.txt"), train_lines, 0, cores, total_lines=train_lines)))
    writer.start()
    CSG.calibration()
    CSG.generate_raw(os.path.join(raw, "test.txt"), test_lines, 1)
    bayes = CSG.bayes_ceiling()
    writer.join()
    t_gen = time.perf_counter() - t0
    cutoff = CSG.scaled_cutoff(train_lines)
    t0 = time.perf_counter()
    info = FC.preprocess(raw, data, cutoff, workers=cores)
    t_pre = time.perf_counter() - t0
    # phase 8c's ladder reads the wide rows from the csv view of these lines
    t0 = time.perf_counter()
    script("torch_zoo_auc").make_csv_view(os.path.join(raw, "train.txt"),
                                         os.path.join(work, "surrogate_csv"))
    with open(os.path.join(work, "surrogate.json"), "w") as f:
        json.dump(dict(stats=shard_stats, bayes=bayes, t_gen=t_gen, cutoff=cutoff, info=info,
                       t_pre=t_pre, t_csv=time.perf_counter() - t0, cores=cores), f)


def surrogate_process(work):
    """Start surrogate_data in a process group of its own (it runs beside
    legs (a)-(d), whose hosts wait on the card and on each other)."""
    return subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.surrogate_data({work!r}, "
                               f"{SURR_TRAIN}, {SURR_TEST})"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def stop_group(proc) -> None:
    """Kill a process started in a session of its own, with its children."""
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def surrogate_leg(dev, work, card, res, proc):
    """Leg (e): the surrogate's files from surrogate_process; DeepFM's
    dense step trains one epoch on the card with
    --field_blocks=auto:<feature_map> (K8 once a step); its eval AUC (the
    harness's 200 thresholds) and exact_auc beside the surrogate's Bayes
    ceiling; K8 timed at the surrogate's blocks."""
    from tf_repos_tpu_torch.features.criteo import field_blocks_from_feature_map
    from tf_repos_tpu_torch.ops.metrics import exact_auc

    try:
        _, err = proc.communicate(timeout=900)
    finally:
        stop_group(proc)
    check(proc.returncode == 0, f"leg (e): the surrogate's process exited {proc.returncode}: "
                                f"{err[-3000:]}")
    with open(os.path.join(work, "surrogate.json")) as f:
        sd = json.load(f)
    data, info, bayes = os.path.join(work, "surrogate"), sd["info"], sd["bayes"]
    check(sd["stats"].get("lines") == SURR_TRAIN, f"surrogate wrote {sd['stats']}")
    fmap = os.path.join(data, "feature_map")
    log(f"leg (e) surrogate: {SURR_TRAIN} train lines (ctr {sd['stats']['ctr']:.4f}, "
        f"{sd['cores']} worker processes) and {SURR_TEST} test lines in {sd['t_gen']:.1f} s; Bayes "
        f"ceiling {bayes:.4f}; preprocess (cutoff {sd['cutoff']}, {sd['cores']} workers) in "
        f"{sd['t_pre']:.1f} s: feature_size {info['feature_size']}; its csv view in "
        f"{sd['t_csv']:.1f} s (beside legs (a)-(d))")
    width = dict(SURR_WIDTH, feature_size=info["feature_size"], field_blocks=f"auto:{fmap}")
    argv = [f"--{k}={v}" for k, v in width.items()] + [
        "--task_type=train", "--num_epochs=1", "--log_steps=50", f"--data_dir={data}",
        f"--model_dir={work}/surrogate_model/", "--dt_dir=smoke", "--eval_throttle_secs=0",
        f"--device={dev.type}", "--seed=2018"]
    FB.reset_launches()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = FB.field_block_scatter.launches
    check(launches == out["step"] > 0, f"leg (e): field_block_scatter launched {launches} times "
                                       f"in {out['step']} steps")
    # exact_auc over the va predictions of the trained checkpoint
    h = Harness(parse_config([a for a in argv if a != "--task_type=train"]))
    ts = h._restore()
    predict = L.build_predict_step(h.model)
    preds, labels, masks = [], [], []
    for b in h._dataset("va", shuffle=False, epochs=1):
        db = to_device(b, dev)
        preds.append(predict(ts["params"], ts["mstate"], db)["prob"])
        labels.append(db["label"])
        masks.append(db["mask"])
    ex = float(exact_auc(torch.cat(labels), torch.cat(preds), torch.cat(masks)))
    log(f"leg (e): DeepFM dense --field_blocks=auto:<feature_map> (B={width['batch_size']}) one "
        f"epoch, {out['step']} steps in {wall:.1f} s on {card}: eval AUC {out['auc']:.4f} (200 "
        f"thresholds), exact_auc {ex:.4f}, Bayes ceiling {bayes:.4f} ({out['auc'] / bayes:.3f} of "
        f"it), loss {out['loss']:.4f}; field_block_scatter launches {launches}")
    check(out["auc"] >= SURR_AUC_BAR and ex >= SURR_AUC_BAR and ex <= bayes + 0.01,
          f"leg (e): eval AUC {out['auc']}, exact {ex} vs bar {SURR_AUC_BAR}, ceiling {bayes}")
    res["e_launches"] = launches
    # K8 at the surrogate's blocks: one training batch, a random cotangent
    offsets, sizes = field_blocks_from_feature_map(fmap)
    vocab, w = info["feature_size"], 1 + WIDTH["embedding_size"]
    ids = torch.from_numpy(next(iter(h._build_reader(
        [os.path.join(data, "tr.libsvm")], "libsvm", shuffle=False, epochs=1)))["feat_ids"]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(34)
    g = torch.randn((ids.shape[0], len(offsets), w), generator=gen, device=dev)
    args = (vocab, offsets, sizes, True)
    e8 = "field_block_scatter (surrogate blocks)"
    err = held(e8, FB.field_block_scatter(ids, g, *args), FB.field_block_scatter_plain(ids, g, *args),
               FB.field_block_scatter_plain(ids, g.abs(), *args))
    i64 = ids.long()
    off, siz = torch.tensor(offsets, device=dev), torch.tensor(sizes, device=dev)
    keep = (i64 >= off) & (i64 < off + siz)
    lib_ids = torch.where(keep, i64, 0).reshape(-1)
    lib_g = torch.where(keep[..., None], g.to(torch.bfloat16).float(), 0.0).reshape(-1, w)
    t = (cuda_ms(lambda: FB.field_block_scatter(ids, g, *args)),
         cuda_ms(lambda: FB.field_block_scatter_plain(ids, g, *args)),
         cuda_ms(lambda: torch.zeros((vocab, w), device=dev).index_add_(0, lib_ids, lib_g)))
    nbytes = ids.numel() * 4 + g.numel() * 4 + vocab * w * 4
    bound = max(nbytes / HBM_BYTES_PER_S, g.numel() / F32_FLOPS) * 1e3
    log(f"kernel {e8} (B={ids.shape[0]}, 39 fields, blocks of sizes {min(sizes)}..{max(sizes)}, "
        f"vocab {vocab}; bf16 mode): max_abs_err {err:.3e}  {t[0]:.4f} ms  plain {t[1]:.4f} ms  "
        f"library (index_add_) {t[2]:.4f} ms  bound {bound:.4f} ms ({bound / t[0]:.2f} of it)")
    res["kernels"]["t"][e8], res["kernels"]["bound"][e8] = t, bound
    res["kernels"]["bound_by"][e8], res["kernels"]["err"][e8] = "bytes", err


def multihost_phase(dev, work, card):
    """Phase 7, several hosts (--dist_mode=2): two host processes on
    127.0.0.1 whose ranks share the one card over gloo (run_two_hosts).
    (a) DeepFM at the bench width with the multihost preset's flags, 2x2
    over two hosts (two ranks each), MH_STEPS steps on each host's file:
    the hosts' loss lines equal, the logged losses held to the
    single-device step on the same global batches (PR 14's bar) and the
    store within 1e-4, K1 and K2 once a step on every rank; (b) ESMM
    --mh_coo --dma_scatter at the published point, 2x1 over two hosts,
    MH_ESMM_STEPS steps, held likewise, K3, K4 and K7 once a step on
    each rank, each host's own COO bucket beside the cross-host one; (c)
    (a)'s checkpoint inferred on two hosts over te files of unequal
    length (the template path), held to the one-process pred.txt; (d)
    --slim_transfer on a one-host 2x2 mesh, MH_SLIM_STEPS steps, held to
    the unwired mesh run; (e) the surrogate (surrogate_leg). Then K1/K2,
    K3/K4 and K7 at a two-host rank's shapes (consensus_point)."""
    surrogate = surrogate_process(work)
    try:
        return multihost_legs(dev, work, card, surrogate)
    finally:
        stop_group(surrogate)


def multihost_legs(dev, work, card, surrogate):
    """multihost_phase's legs, (e) on the files of ``surrogate``."""
    from tf_repos_tpu_torch.parallel.launch import run_on_mesh

    t_all = time.perf_counter()
    res = {}
    # (a)
    data = os.path.join(work, "mh_data")
    os.makedirs(data)
    n = MH_STEPS * B
    split_lines(os.path.join(work, "data", "tr.libsvm"),
                [(os.path.join(data, "tr.part0.libsvm"), 0, n),
                 (os.path.join(data, "tr.part1.libsvm"), MAIN_STEPS * B - n, MAIN_STEPS * B)])
    shutil.copy(os.path.join(work, "data", "va.libsvm"), os.path.join(data, "va.libsvm"))
    base = [f"--{k}={v}" for k, v in WIDTH.items()] + [
        "--preset=multihost", "--num_epochs=1", "--log_steps=1", f"--data_dir={data}",
        "--dt_dir=smoke", "--eval_throttle_secs=0", "--seed=2018"]
    mh = [*base, "--task_type=train", f"--model_dir={work}/mh_a/", "--mesh_data=2",
          "--mesh_model=2", f"--device={dev.type}"]
    outs, outa = run_two_hosts(work, "a", mesh_rank, (mh, 5, False), 2, 2, dev)
    steps = outa[0]["res"]["step"]
    lines = [[ln.split(" (")[0] for ln in o.splitlines() if ln.startswith("INFO: step = ")]
             for o in outs]
    check(steps == MH_STEPS and lines[0] == lines[1] and len(lines[0]) >= 2,
          f"leg (a): {steps} steps; host loss lines {lines}")
    want, want_store = single_device_reference(dev, base, MH_STEPS, SparseBatchMapper(
        create_model(Config(**WIDTH)).sparse_slots()))
    got = train_losses(f"{work}/mh_a")
    rel = held_losses("leg (a) two-host 2x2 DeepFM", got, [(s, want[s - 1]) for s, _ in got])
    dstore = held_store("leg (a)", checkpoint_store(f"{work}/mh_a", "fm_wv"), want_store,
                        1 + WIDTH["embedding_size"], WIDTH["learning_rate"], MH_STEPS)
    res["a"] = dict(outa[0], launches=mesh_launches("leg (a)", outa[0], steps,
                                                    ("expand_rows", "accumulate_rows")), steps=steps)
    res["a"]["share"] = mesh_rank_line(
        f"leg (a) DeepFM 2x2 over 2 hosts, B={B} a host", outa[0], steps, card)
    log(f"leg (a): host 0 {outs[0].count('INFO: step')} loss lines = host 1's; logged losses "
        f"{[round(v, 6) for _, v in got]} within {rel:.2e} relative of the single-device step on "
        f"the global batches ({MH_HOSTS * B} rows); store within {dstore:.2e}; eval loss "
        f"{outa[0]['res']['loss']:.6f} auc {outa[0]['res']['auc']:.6f} on host 0, "
        f"{outa[1]['res']['loss']:.6f} / {outa[1]['res']['auc']:.6f} on host 1")

    # (b)
    edata = os.path.join(work, "mh_esmm")
    os.makedirs(edata)
    n = MH_ESMM_STEPS * EB
    split_lines(os.path.join(work, "esmm_data", "tr.samples.txt"),
                [(os.path.join(edata, "tr.part0"), 0, n),
                 (os.path.join(edata, "tr.part1"), ESMM_STEPS * EB - n, ESMM_STEPS * EB)])
    shutil.copy(os.path.join(work, "esmm_data", "va.samples.txt"),
                os.path.join(edata, "va.samples.txt"))
    ebase = [f"--{k}={v}" for k, v in ESMM_WIDTH.items()] + [
        "--num_epochs=1", "--log_steps=1", f"--data_dir={edata}", "--dt_dir=smoke",
        "--eval_throttle_secs=0", "--seed=2018"]
    emh = [*ebase, "--task_type=train", f"--model_dir={work}/mh_b/", "--mesh_data=2",
           "--mesh_model=1", f"--device={dev.type}"]
    _, outb = run_two_hosts(work, "b", mesh_rank, (emh, 3, False, True), 2, 1, dev)
    steps = outb[0]["res"]["step"]
    check(steps == MH_ESMM_STEPS, f"leg (b) ran {steps} steps")
    emodel = create_model(Config(**ESMM_WIDTH))
    want, want_store = single_device_reference(dev, ebase, MH_ESMM_STEPS, esmm_chain(emodel))
    got = train_losses(f"{work}/mh_b")
    rel = held_losses("leg (b) two-host ESMM", got, [(s, want[s - 1]) for s, _ in got])
    dstore = held_store("leg (b)", checkpoint_store(f"{work}/mh_b", "emb"), want_store,
                        ESMM_WIDTH["embedding_size"], ESMM_WIDTH["learning_rate"], MH_ESMM_STEPS,
                        mv_bar=None)
    res["b"] = dict(outb[0], launches=mesh_launches(
        "leg (b)", outb[0], steps, ("accumulate_rows", "coo_accumulate_rows", "dma_row_scatter"),
        ("expand_rows", "coo_pool_rows")), steps=steps)
    pool = [row[2] for row in outb[0]["counts"]]
    check(all(c >= steps for c in pool), f"leg (b): coo_pool_rows launched {pool} times on the "
                                         f"ranks in {steps} steps, expected at least one a step")
    res["b"]["share"] = mesh_rank_line(f"leg (b) ESMM 2x1 over 2 hosts, B={EB} a host", outb[0],
                                       steps, card)
    for o in outb:
        own, agreed = o["coo"]
        log(f"leg (b) host {o['host']}: its own COO bucket per step {own[:steps]}, the cross-host "
            f"one {agreed[:steps]}")
    check(outb[0]["coo"][1] == outb[1]["coo"][1], "leg (b): the hosts' COO buckets disagree")
    log(f"leg (b): logged losses within {rel:.2e} relative of the single-device step on the "
        f"global batches ({MH_HOSTS * EB} rows); store (w) within {dstore:.2e}")

    # (c) infer of (a)'s checkpoint over two te files of unequal length
    idata = os.path.join(work, "mh_infer")
    os.makedirs(idata)
    split_lines(os.path.join(work, "data", "tr.libsvm"),
                [(os.path.join(idata, "te.part0.libsvm"), 0, MH_INFER_ROWS[0]),
                 (os.path.join(idata, "te.part1.libsvm"), MH_INFER_ROWS[0],
                  sum(MH_INFER_ROWS))])
    iargv = [f"--{k}={v}" for k, v in WIDTH.items()] + [
        "--task_type=infer", f"--data_dir={idata}", f"--model_dir={work}/mh_a/", "--dt_dir=smoke",
        "--compute_dtype=float32", f"--device={dev.type}"]
    t0 = time.perf_counter()
    run_two_hosts(work, "c", multihost_task, ([*iargv, "--mesh_data=2", "--mesh_model=2"],), 2, 2,
                  dev)
    t_two = time.perf_counter() - t0
    two = np.loadtxt(os.path.join(idata, "pred.txt"))
    SR.reset_launches()
    one = np.loadtxt(cli.main([*iargv, "--mesh_data=1", "--mesh_model=1"]))
    check(two.shape == one.shape == (sum(MH_INFER_ROWS),), f"leg (c): {two.shape} vs {one.shape}")
    d = np.abs(two - one)
    check(bool((d <= 1e-5 * np.abs(one) + 1e-6).all()),
          f"leg (c): two-host pred.txt differs from the one-process one by {d.max()}")
    log(f"leg (c): (a)'s checkpoint inferred on two hosts (te files of {MH_INFER_ROWS} lines: "
        f"host 1 feeds the template batch for 2 of the 3 steps) in {t_two:.1f} s: "
        f"{two.shape[0]} lines, max abs difference {d.max():.2e} from the one-process pred.txt "
        f"(f32 towers; K1 {SR.expand_rows.launches} launches in the one-process infer)")

    # (d) the slim wire on a one-host 2x2 mesh
    sdata = os.path.join(work, "mh_slim")
    os.makedirs(sdata)
    split_lines(os.path.join(work, "data", "tr.libsvm"),
                [(os.path.join(sdata, "tr.libsvm"), 0, MH_SLIM_STEPS * B)])
    shutil.copy(os.path.join(work, "data", "va.libsvm"), os.path.join(sdata, "va.libsvm"))
    sbase = [f"--{k}={v}" for k, v in WIDTH.items()] + [
        "--task_type=train", "--num_epochs=1", "--log_steps=1", f"--data_dir={sdata}",
        "--dt_dir=smoke", "--eval_throttle_secs=0", "--seed=2018", "--mesh_data=2",
        "--mesh_model=2", f"--device={dev.type}"]
    runs = {}
    for slim in ("false", "true"):
        argv = [*sbase, f"--model_dir={work}/mh_d_{slim}/", f"--slim_transfer={slim}"]
        runs[slim] = run_on_mesh(multihost_task, (argv,), data=2, model=2, devices=[dev] * 4)
    check(runs["true"]["step"] == runs["false"]["step"] == MH_SLIM_STEPS,
          f"leg (d): {runs}")
    rel = held_losses("leg (d) slim 2x2", train_losses(f"{work}/mh_d_true"),
                      train_losses(f"{work}/mh_d_false"))
    dstore = held_store("leg (d)", checkpoint_store(f"{work}/mh_d_true", "fm_wv"),
                        checkpoint_store(f"{work}/mh_d_false", "fm_wv"),
                        1 + WIDTH["embedding_size"], WIDTH["learning_rate"], MH_SLIM_STEPS)
    log(f"leg (d): --slim_transfer on a one-host 2x2 mesh, {MH_SLIM_STEPS} steps: losses within "
        f"{rel:.2e} relative of the unwired mesh run's, store within {dstore:.2e}; eval "
        f"{runs['true']['loss']:.6f} / {runs['false']['loss']:.6f}")
    res["kernels"] = consensus_point(dev)
    surrogate_leg(dev, work, card, res, surrogate)
    log(f"multihost phase: {time.perf_counter() - t_all:.1f} s")
    return res


def multihost_rows(mh):
    """The kernel report's phase-7 rows: K1/K2 at a two-host 2x2 rank, K3,
    K4 and K7 at a two-host ESMM rank (the COO consensus), K8 on the
    surrogate's blocks, each with the launches of one rank (every rank
    alike) of its leg."""
    counts = {"expand_rows (two-host 2x2 rank)": mh["a"]["launches"]["expand_rows"],
              "accumulate_rows (two-host 2x2 rank)": mh["a"]["launches"]["accumulate_rows"],
              "coo_pool_rows (two-host rank)": mh["b"]["launches"]["coo_pool_rows"],
              "coo_accumulate_rows (two-host rank)": mh["b"]["launches"]["coo_accumulate_rows"],
              "dma_row_scatter (two-host rank)": mh["b"]["launches"]["dma_row_scatter"],
              "field_block_scatter (surrogate blocks)": mh["e_launches"]}
    src = {"expand_rows (two-host 2x2 rank)":
           ("sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:164"),
           "accumulate_rows (two-host 2x2 rank)":
           ("sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:208"),
           "coo_pool_rows (two-host rank)": ("coo_pool.cu", "tf_repos_tpu/ops/pallas_sparse.py:463"),
           "coo_accumulate_rows (two-host rank)":
           ("coo_pool.cu", "tf_repos_tpu/ops/pallas_sparse.py:514"),
           "dma_row_scatter (two-host rank)":
           ("row_scatter.cu", "tf_repos_tpu/ops/pallas_sparse.py:1472"),
           "field_block_scatter (surrogate blocks)":
           ("field_block.cu", "tf_repos_tpu/ops/pallas_embedding.py:103")}
    return [(name, cu, tpu, mh["kernels"], counts) for name, (cu, tpu) in src.items()]


def multihost_only(dev, work, card) -> int:
    """--only=multihost: phase 7 alone, on the main paths' files written
    here as phase 4 writes them; its kernel rows, and no result line."""
    try:
        for d in ("data", "esmm_data"):
            os.makedirs(os.path.join(work, d))
        write_in_parts("libsvm", os.path.join(work, "data", "tr.libsvm"), MAIN_STEPS * B, 1,
                       feature_size=WIDTH["feature_size"], zipf_a=1.2)
        write_synthetic_libsvm(os.path.join(work, "data", "va.libsvm"), B, WIDTH["feature_size"],
                               seed=2, zipf_a=1.2)
        write_in_parts("aliccp", os.path.join(work, "esmm_data", "tr.samples.txt"),
                       ESMM_STEPS * EB, 1, feature_size=ESMM_WIDTH["feature_size"], zipf_a=1.2)
        write_synthetic_aliccp(os.path.join(work, "esmm_data", "va.samples.txt"), EB,
                               ESMM_WIDTH["feature_size"], seed=2, zipf_a=1.2,
                               mh_avg_lens=PUBLISHED_MH_AVG_LENS)
        mh = multihost_phase(dev, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, _, _, phase, counts in multihost_rows(mh):
        ms, plain, lib = phase["t"][name]
        log(f"row {name}: launches {counts[name]}, {ms:.4f} ms, plain {plain:.4f} ms, library "
            f"{lib:.4f} ms, bound {phase['bound'][name]:.4f} ms ({phase['bound_by'][name]})")
    log("phase 7 alone (--only=multihost): no result line")
    return 0


# ------------------------------------------------------------------ phase 8
# the serving load benchmarks and the zoo AUC ladder, each through its
# script as a user runs it: (a) the latency fit, (b) the load curve on (a)'s
# servable, (c) the ladder's DeepFM and LR rows on phase 7e's surrogate
LOAD_ARGV = ["--protocols=rest,example", "--concurrency=1,8,32", "--duration=2"]
LADDER_ROWS = ("DeepFM", "LR")
# one epoch of the 270,000 train lines at the rows' published flags
# (DeepFM lr 1e-4: ~1,050 steps, a seventh of the full ladder's); phase
# 7e's 0.70 is at lr 1e-3 (PERF.md, written before the first run)
LADDER_AUC_BAR = 0.65


def latency_fit_leg(card):
    """(a) scripts/torch_bench_serving.py --repeats=10 on the card: its own
    DeepFM servable, one client; each batch size's K1 launches equal to
    the micro-batches the server scored and to the requests sent, each
    batch's predictions held to a CPU Scorer on the same servable (1e-5
    relative: the bench servable's towers are f32); the fit and the
    /stats split logged."""
    res = script("torch_bench_serving").main(["--repeats=10"])
    cpu = Scorer(res["servable"], warmup=False, device="cpu")
    worst = 0.0
    for n, b in res["batches"].items():
        check(b["k1_launches"] == b["scored_batches"] == b["requests"],
              f"(a) batch {n}: K1 launched {b['k1_launches']} times for {b['scored_batches']} "
              f"scored micro-batches of {b['requests']} requests")
        worst = max(worst, held_rel(f"(a) batch {n} card vs CPU scorer", b["predictions"],
                                    cpu.score(b["instances"])["prob"], 1e-5))
    fit, st = res["fit"], res["stats"]
    log(f"phase 8 (a) latency fit on {card}: {fit['ms_per_example']}*batch + {fit['ms_fixed']} "
        f"ms; /stats batchify p50 {fit['server_batchify_ms_p50']} ms, device p50 "
        f"{fit['server_device_ms_p50']} ms, score p50 {st.get('score_ms', {}).get('p50')} ms, "
        f"occupancy {st.get('n', {}).get('mean')}; bare device sync {fit['bare_device_sync_ms']} "
        f"ms, fixed cost less it {fit['ms_fixed_colocated_est']} ms; K1 once a request at "
        f"every batch size; card vs CPU scorer max abs diff {worst:.3e} (held at 1e-5 "
        "relative + 1e-6)")
    return res


def load_leg(card, servable):
    """(b) scripts/torch_bench_serving_load.py on (a)'s servable, rest and
    example at 1, 8 and 32 clients for 2 s each: every level answered
    with no error and no shed, occupancy at least 1, and K1 launched once
    for each micro-batch the server scored, which lies between the
    level's instances over max_batch and its requests."""
    res = script("torch_bench_serving_load").main(
        [*LOAD_ARGV, f"--servable_model_dir={servable}"])
    for name, cell in res["result"].items():
        n = res["counts"][name]
        check(cell["errors"] == 0 and cell["shed"] == 0 and cell["requests"] > 0
              and cell["batch_occupancy_mean"] >= 1, f"(b) {name}: {cell}")
        lo = cell["requests"] * res["per_req"] / res["max_batch"]
        check(n["k1_launches"] == n["scored_batches"] and lo <= n["scored_batches"] <=
              cell["requests"], f"(b) {name}: K1 launched {n['k1_launches']} times for "
              f"{n['scored_batches']} scored micro-batches of {cell['requests']} requests")
        log(f"phase 8 (b) {name} on {card}: {cell['req_per_s']} req/s "
            f"({cell['examples_per_s']} examples/s), p50 {cell['p50_ms']} ms, p99 "
            f"{cell['p99_ms']} ms, occupancy {cell['batch_occupancy_mean']} (window of 256 "
            f"batches), device p50 {cell['device_ms_p50']} ms; {cell['requests']} requests in "
            f"{n['scored_batches']} micro-batches, K1 {n['k1_launches']} launches")
    return res


def ladder_leg(dev, work, card):
    """(c) scripts/torch_zoo_auc.py, DeepFM and LR (wide on the csv view),
    on phase 7e's surrogate files and csv view (linked into the ladder's
    work dir, so nothing is generated again) with phase 7e's Bayes
    ceiling in the script's resume file: both rows without error, each
    AUC at least LADDER_AUC_BAR and at most the ceiling + 0.01; then
    task_type=infer on each row's checkpoint over the te lines (DeepFM:
    the preprocessed te.libsvm; wide: the csv view's va lines as te), K1
    once a table gather a batch, pred.txt held to a CPU infer within 2e-5
    relative (+ 1e-6, a unit of the file's sixth decimal); K1 at each
    infer's gather as serving_k1 checks and times it, on the first batch's
    ids and the row's trained table. Returns {row: (times, bound,
    launches)}."""
    from tf_repos_tpu_torch.models.wide_deep import WideDeep
    from tf_repos_tpu_torch.train.checkpoint import CheckpointManager
    from tf_repos_tpu_torch.train.harness import run_task

    ZA = script("torch_zoo_auc")
    with open(os.path.join(work, "surrogate.json")) as f:
        sd = json.load(f)
    lad = os.path.join(work, "ladder")
    os.makedirs(lad)
    for link, target in (("raw", "surrogate_raw"), ("proc", "surrogate"), ("csv", "surrogate_csv")):
        os.symlink(os.path.join(work, target), os.path.join(lad, link))
    fs = sum(1 for _ in open(os.path.join(lad, "proc", "feature_map")))
    check(fs == sd["info"]["feature_size"], f"(c) feature_map {fs} lines, {sd['info']}")
    ZA.write_stamp(lad, SURR_TRAIN, SURR_TEST)
    out = os.path.join(lad, "zoo.json")
    with open(out, "w") as f:
        json.dump({"train_lines": SURR_TRAIN, "feature_size": fs,
                   "bayes_ceiling": round(sd["bayes"], 4), "runs": {}}, f)
    t0 = time.perf_counter()
    res = ZA.main([f"--train_lines={SURR_TRAIN}", f"--test_lines={SURR_TEST}",
                   f"--models={','.join(LADDER_ROWS)}", f"--work_dir={lad}", f"--out={out}",
                   f"--device={dev.type}"])
    t_ladder = time.perf_counter() - t0
    ceiling = res["bayes_ceiling"]
    check(res["feature_size"] == fs and sorted(res["runs"]) == sorted(LADDER_ROWS), f"(c) {res}")
    for name in LADDER_ROWS:
        r = res["runs"][name]
        check("error" not in r and LADDER_AUC_BAR <= r["auc"] <= ceiling + 0.01,
              f"(c) {name}: {r} (bar {LADDER_AUC_BAR}, ceiling {ceiling})")
    log(f"phase 8 (c) ladder on phase 7e's {SURR_TRAIN} lines (feature_size {fs}, ceiling "
        f"{ceiling}) in {t_ladder:.1f} s: " + ", ".join(
            f"{n} ({res['runs'][n]['model']}) auc {res['runs'][n]['auc']} in "
            f"{res['runs'][n]['wall_s']} s" for n in LADDER_ROWS) + f" on {card}")
    rows = {r[0]: r for r in ZA.LADDER}
    launches = {}
    for name in LADDER_ROWS:
        row = rows[name]
        wide = row[3].get("optimizer") == "wdl"
        idir = os.path.join(work, "ladder_infer", name)
        os.makedirs(idir)
        te = os.path.join(idir, "te.csv" if wide else "te.libsvm")
        os.symlink(os.path.join(lad, "csv", "va.csv") if wide else
                   os.path.join(lad, "proc", "te.libsvm"), te)
        lines = sum(1 for _ in open(te))
        cfg = ZA.row_config(row, fs, lad, device=dev.type).replace(task_type="infer",
                                                                   data_dir=idir)
        SR.reset_launches()
        t0 = time.perf_counter()
        card_path = run_task(cfg)
        k1 = SR.expand_rows.launches
        t_card = time.perf_counter() - t0
        got = np.loadtxt(card_path)
        os.remove(card_path)
        want = np.loadtxt(run_task(cfg.replace(device="cpu")))
        batches = -(-lines // cfg.batch_size)
        # one table gather a predict step: DeepFM's [V, 1+K] table over all
        # 39 fields, wide's wide_cat table (its [V, 1] view)
        check(k1 == batches, f"(c) {name} infer: K1 launched {k1} times for {batches} batches "
              "of one gather")
        check(got.shape == (lines,), f"(c) {name} infer: pred.txt shape {got.shape}")
        err = held_rel(f"(c) {name} infer card vs CPU", got, want, 2e-5)
        log(f"phase 8 (c) {name} infer: {lines} te lines in {batches} batches in {t_card:.1f} s "
            f"on {card}, K1 {k1} launches; pred.txt vs a CPU infer max abs diff {err:.3e} "
            "(held at 2e-5 relative + 1e-6)")
        with open(te, "rb") as f:
            first = [next(f) for _ in range(cfg.batch_size)]
        params = CheckpointManager(cfg.resolved_model_dir()).restore(dev)["params"]
        # no device-operation count here: see serving_load_phase
        if wide:
            ids = WideDeep._offset_ids(torch.from_numpy(parse_csv_lines(first)["cat"]).to(dev))
            t, bound = serving_k1(f"ladder {name} infer wide_cat batch {cfg.batch_size}",
                                  params["wide_cat"][:, None], ids, count_ops=False)
        else:
            ids, _, _ = parse_libsvm_lines(first, cfg.field_size)
            t, bound = serving_k1(f"ladder {name} infer batch {cfg.batch_size}", params["fm_wv"],
                                  torch.from_numpy(ids).to(dev), count_ops=False)
        launches[name] = (t, bound, k1)
        del params
    return launches


def serving_load_phase(dev, work, card):
    """Phase 8: (a), (b) and (c) above. Returns the kernel report's phase
    and launch counts for K1's rows of phase 8, each at its own shapes:
    the bench servable's gather with the launches of (a) and (b) together
    (counts zeroed just before (a), read just after (b)), timed at (a)'s
    largest batch (256, the largest micro-batch either leg scores), and
    each ladder row's infer gather with that infer's launches."""
    t0 = time.perf_counter()
    SR.reset_launches()
    fit = latency_fit_leg(card)
    t_a = time.perf_counter() - t0
    load_leg(card, fit["servable"])
    ab = SR.expand_rows.launches
    largest = fit["batches"][max(fit["batches"])]
    table = Scorer(fit["servable"], warmup=False, device="cpu").params["fm_wv"].to(dev)
    ids = torch.from_numpy(np.asarray([i["feat_ids"] for i in largest["instances"]],
                                      np.int32)).to(dev)
    # the one-launch count (torch.profiler) is held at phase 4b's gathers,
    # not at phase 8's: after phase 8's runs in this process the profiler
    # traced no device operation of the one-launch gather in three
    # attempts, though the five-launch gather just before it traced
    # (PERF.md §7)
    res = {"expand_rows (serving load, DeepFM bench servable)":
           (*serving_k1(f"bench servable batch {len(ids)}", table, ids, count_ops=False), ab)}
    del table
    shutil.rmtree(os.path.dirname(fit["servable"]), ignore_errors=True)
    t_b = time.perf_counter() - t0 - t_a
    for name, r in ladder_leg(dev, work, card).items():
        res[f"expand_rows (infer, zoo ladder {name})"] = r
    log(f"phase 8: (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) "
        f"{time.perf_counter() - t0 - t_a - t_b:.1f} s; K1 launches "
        + ", ".join(f"{k} {r[2]}" for k, r in res.items()))
    phase = {"t": {k: r[0] for k, r in res.items()}, "bound": {k: r[1] for k, r in res.items()},
             "bound_by": "bytes", "err": {k: 0.0 for k in res}}
    return phase, {k: r[2] for k, r in res.items()}


def serving_load_only(dev, work, card) -> int:
    """--only=serving_load: phase 7e's surrogate files (written here as its
    process writes them), then phase 8 alone; no result line."""
    try:
        t0 = time.perf_counter()
        surrogate_data(work, SURR_TRAIN, SURR_TEST)
        log(f"surrogate files in {time.perf_counter() - t0:.1f} s")
        phase, launches = serving_load_phase(dev, work, card)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, n in launches.items():
        ms, plain, lib = phase["t"][name]
        log(f"row {name}: launches {n}, {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
            f"bound {phase['bound'][name]:.5f} ms (bytes)")
    log("phase 8 alone (--only=serving_load): no result line")
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this smoke needs a GPU",
              file=sys.stderr)
        return 1
    args = sys.argv[1:]
    profile = None
    if "--profile" in args:
        profile = next((a.split("=", 1)[1] for a in args if a.startswith("--trace=")), "")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t_start = time.perf_counter()
    card = card_label(dev)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    PHASE_S["1"] = time.perf_counter() - t_start

    t0 = time.perf_counter()
    logs = timed("2", build.build_all)
    log(f"build: {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")

    work = os.path.join(HERE, "_smoke_tmp")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    if "--only=multihost" in args:
        return multihost_only(dev, work, card)
    if "--only=serving_load" in args:
        return serving_load_only(dev, work, card)
    if "--only=att_unit" in args:
        return att_unit_only(dev)
    if "--only=step_graph" in args:
        return step_graph_only(dev)
    try:
        kp = timed("3", kernel_phase, dev)
        ekp = timed("3", esmm_kernel_phase, dev)
        dkp = timed("3", din_kernel_phase, dev)
        akp = timed("3", att_unit_kernel_phase, dev)
        skp = timed("3", scatter_kernel_phase, dev)
        fkp = timed("3", field_block_kernel_phase, dev)
        zkp = timed("3", zoo_kernel_phase, dev)
        ukp = timed("3", unfused_kernel_phase, dev)
        timed("3", rounding_phase, dev)
        bkp = timed("3", bf16_store_kernel_phase, dev)
        rates = {}  # host-input stage times and CLI examples/s, printed with the bare steps
        launches = timed("4", main_path, dev, work, rates)
        zoo = timed("4", zoo_main_path, dev, work)
        lazy = timed("4", lazy_optimizers_main_path, dev, work, rates)
        wd_peak = timed("4", wide_deep_main_path, dev, work, rates)
        elaunches = timed("4", esmm_main_path, dev, work, rates)
        dlaunches = timed("4", din_main_path, dev, work, rates)
        flaunches = timed("4", field_block_main_path, dev, work, rates)
        mesh = timed("6", mesh_phase, dev, work, card)
        multihost = timed("7", multihost_phase, dev, work, card)
        presets = timed("4", presets_path, dev, work)
        serve_kp, serve_launches = timed("4b", serving_phase, dev, work)
        load_kp, load_launches = timed("8", serving_load_phase, dev, work, card)
        bare = timed("4", bare_steps, dev, profile)
        ebare = timed("4", esmm_bare_step, dev, profile)
        dbare = {sb: timed("4", din_bare_step, dev, profile, sb) for sb in (False, True)}
        dbare["dma"] = timed("4", din_bare_step, dev, profile, False, True)
        zbare = {name: timed("4", zoo_bare_step, dev, name, profile) for name in ZOO}
        lbare = timed("4", lazy_bare_steps, dev, profile)
        wbare = {m: timed("4", wd_bare_step, dev, profile, m) for m in ("wide_n_deep", "wide")}
        for traj in (trajectory, lazy_trajectory, wd_trajectory, zoo_trajectory, esmm_trajectory,
                     din_trajectory, field_block_trajectory, bf16_trajectories):
            timed("5", traj, dev)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # K1/K2 launches from the DeepFM main path, K3/K4 and K7 from the ESMM
    # one, K5/K6 from the DIN one (K5 at n_out = Su from its --coo_sorted_bwd
    # leg), K8 from the DeepFM --field_blocks one
    kernels = [
        ("expand_rows", "sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:164", kp, launches),
        ("accumulate_rows", "sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:208", kp, launches),
        ("accumulate_rows (ESMM point)", "sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:289",
         ekp, elaunches),
        ("accumulate_rows (DIN COO lookup)", "sparse_rows.cu",
         "tf_repos_tpu/ops/pallas_sparse.py:289", dkp, dlaunches),
        ("accumulate_rows (DIN shared lookup)", "sparse_rows.cu",
         "tf_repos_tpu/ops/pallas_sparse.py:289", dkp, dlaunches),
        ("coo_pool_rows", "coo_pool.cu", "tf_repos_tpu/ops/pallas_sparse.py:463", ekp, elaunches),
        ("coo_accumulate_rows", "coo_pool.cu", "tf_repos_tpu/ops/pallas_sparse.py:514", ekp,
         elaunches),
        ("sorted_segsum", "sorted_seg.cu", "tf_repos_tpu/ops/pallas_sparse.py:1012", dkp, dlaunches),
        ("sorted_expand", "sorted_seg.cu", "tf_repos_tpu/ops/pallas_sparse.py:1057", dkp, dlaunches),
        ("sorted_segsum (n_out=Su)", "sorted_seg.cu", "tf_repos_tpu/ops/pallas_sparse.py:1171", dkp,
         dlaunches),
        ("att_unit", "att_unit.cu", "none: XLA ran DIN's attention MLP", akp, dlaunches),
        ("dma_row_scatter", "row_scatter.cu", "tf_repos_tpu/ops/pallas_sparse.py:1472", skp, elaunches),
        ("field_block_scatter", "field_block.cu", "tf_repos_tpu/ops/pallas_embedding.py:103", fkp,
         flaunches),
    ] + [(name, "sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:164", serve_kp, serve_launches)
         for name in serve_launches]
    # phase 8's K1 rows: the bench servable under (a) and (b), each ladder
    # row's infer, each timed at its own table and ids
    kernels += [(name, "sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:164", load_kp,
                 load_launches) for name in load_launches]
    # K1/K2 at the zoo's widths, with the launches of the zoo CLI runs that
    # ran at each width
    zoo_launches = {f"{k} (zoo, {point})": sum(zoo[m][0][k] for m in models)
                    for point, (_, models) in ZOO_POINTS.items()
                    for k in ("expand_rows", "accumulate_rows")}
    kernels += [(name, "sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:164"
                 if name.startswith("expand") else "tf_repos_tpu/ops/pallas_sparse.py:208", zkp,
                 zoo_launches) for name in zoo_launches]
    # K1/K2 on the unfused store, with the launches of the four lazy-optimizer
    # CLI runs
    lazy_launches = {f"{k} (unfused store, stride 17)": sum(lazy[o][0][k] for o in LAZY_OPTS)
                     for k in ("expand_rows", "accumulate_rows")}
    kernels += [(name, "sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:164"
                 if name.startswith("expand") else "tf_repos_tpu/ops/pallas_sparse.py:208", ukp,
                 lazy_launches) for name in lazy_launches]
    # K1/K2 on rows from the bf16 store, with the launches of the
    # esmm_large_vocab CLI run
    bf16_launches = {f"{k} (bf16 store, ESMM point)": presets["esmm_large_vocab"][1][k]
                     for k in ("expand_rows", "accumulate_rows")}
    kernels += [(name, "sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:164"
                 if name.startswith("expand") else "tf_repos_tpu/ops/pallas_sparse.py:289", bkp,
                 bf16_launches) for name in bf16_launches]
    # the mesh legs' kernels timed at a rank's own inputs, with the launches
    # of one rank (every rank alike): K1/K2 at the 2x2 DeepFM rank's shapes,
    # K7 on the 1x2 ESMM rank's store shard. A 1x2 rank's K3/K4 inputs are
    # the single-device ESMM step's (the data axis is 1): the ESMM rows
    # above stand for them, and mesh_launches checked their counts
    mkp = mesh["kernels"]
    mesh_counts = {f"{k} (2x2 mesh rank)": mesh["a"]["launches"][k]
                   for k in ("expand_rows", "accumulate_rows")}
    mesh_counts["dma_row_scatter (1x2 mesh rank)"] = mesh["b"]["launches"]["dma_row_scatter"]
    kernels += [
        ("expand_rows (2x2 mesh rank)", "sparse_rows.cu", "tf_repos_tpu/ops/pallas_sparse.py:164",
         mkp, mesh_counts),
        ("accumulate_rows (2x2 mesh rank)", "sparse_rows.cu",
         "tf_repos_tpu/ops/pallas_sparse.py:208", mkp, mesh_counts),
        ("dma_row_scatter (1x2 mesh rank)", "row_scatter.cu",
         "tf_repos_tpu/ops/pallas_sparse.py:1472", mkp, mesh_counts),
    ]
    kernels += multihost_rows(multihost)
    report = []
    for name, src, replaces, phase, counts in kernels:
        ms, plain, lib = phase["t"][name]
        by = phase["bound_by"]
        report.append({
            "name": name, "route": "cuda", "source": f"tf_repos_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": phase["err"][name], "ms": ms, "plain_ms": plain,
            "bound_ms": phase["bound"][name], "bound_by": by[name] if isinstance(by, dict) else by,
            "library_ms": lib,
        })
    log(f"bare sparse step DeepFM {bare['sparse']:.3f} ms = {B / bare['sparse'] * 1e3:.0f} "
        f"examples/s, dense --field_blocks {bare['dense+field_blocks']:.3f} ms = "
        f"{B / bare['dense+field_blocks'] * 1e3:.0f} examples/s, ESMM --mh_coo --dma_scatter "
        f"{ebare:.3f} ms = {EB / ebare * 1e3:.0f} examples/s, "
        f"DIN --mh_coo {dbare[False]:.3f} ms = {EB / dbare[False] * 1e3:.0f} examples/s, "
        f"with --coo_sorted_bwd {dbare[True]:.3f} ms = {EB / dbare[True] * 1e3:.0f} examples/s, "
        f"with --dma_scatter {dbare['dma']:.3f} ms = {EB / dbare['dma'] * 1e3:.0f} examples/s "
        f"on {card}")
    bare_rate = {"DeepFM CLI": B / bare["sparse"] * 1e3,
                 "DeepFM dense --field_blocks CLI": B / bare["dense+field_blocks"] * 1e3,
                 "ESMM CLI, cache build": EB / ebare * 1e3, "ESMM CLI, cache hit": EB / ebare * 1e3,
                 "ESMM CLI, cache hit, --map_workers=1": EB / ebare * 1e3,
                 "DIN main path": EB / dbare[False] * 1e3,
                 "DIN --coo_sorted_bwd --map_workers=2": EB / dbare[True] * 1e3}
    log(f"host input on {card}, os.cpu_count()={os.cpu_count()}: "
        + ", ".join(f"{k} {v:.2f}" for k, v in rates.items() if k.endswith(" ms")))
    for leg, r in bare_rate.items():
        log(f"CLI vs bare step, {leg}: {rates[leg]:.0f} vs {r:.0f} examples/s "
            f"({rates[leg] / r:.3f} of the bare step); the input alone {rates[leg + ' host']:.0f} "
            f"({rates[leg + ' host'] / r:.3f})")
    for name, (ms, peak) in zbare.items():
        b = zoo_width(name)["batch_size"]
        log(f"zoo {name} at B={b}: CLI {zoo[name][2]:.0f} examples/s vs bare step {ms:.3f} ms = "
            f"{b / ms * 1e3:.0f} examples/s ({zoo[name][2] / (b / ms * 1e3):.3f} of the bare step); "
            f"peak device memory CLI {zoo[name][3] / 2**30:.2f} GiB, bare step {peak / 2**30:.2f} "
            f"GiB on {card}")
    for opt, ms in lbare.items():
        cli_rate = rates[f"DeepFM lazy {opt} CLI"]
        log(f"lazy {opt} (DeepFM, unfused store): CLI {cli_rate:.0f} examples/s vs bare step "
            f"{ms:.3f} ms = {B / ms * 1e3:.0f} examples/s ({cli_rate / (B / ms * 1e3):.3f} of the "
            f"bare step); launches {lazy[opt][0]} in {lazy[opt][1]} steps on {card}")
    for leg, peak in wd_peak.items():
        model = "wide" if leg.startswith("wide CLI") else "wide_n_deep"
        ms, bpeak = wbare[model]
        r = B / ms * 1e3
        host = (f"; the input alone {rates[leg + ' host']:.0f} ({rates[leg + ' host'] / r:.3f})"
                if leg + " host" in rates else "")
        log(f"{leg} (wdl, K=32, B={B}, published 128): CLI {rates[leg]:.0f} examples/s vs bare "
            f"step {ms:.3f} ms = {r:.0f} examples/s ({rates[leg] / r:.3f} of the bare step){host}; "
            f"peak device memory CLI {peak / 2**30:.2f} GiB, bare step {bpeak / 2**30:.2f} GiB; "
            f"Python csv parse {rates['wide_n_deep python parse ms']:.1f} ms a batch on {card}")
    for name, (res, launches, rate, peak, bare) in presets.items():
        b = parse_config(preset_argv(dev, "", name, "x")).batch_size
        r = b / bare["bare ms"] * 1e3
        log(f"preset {name} (B={b}): CLI {rate:.0f} examples/s vs bare step {bare['bare ms']:.3f} ms "
            f"= {r:.0f} examples/s ({rate / r:.3f} of the bare step); peak device memory CLI "
            f"{peak / 2**30:.2f} GiB, bare step {bare['bare peak'] / 2**30:.2f} GiB; tables and "
            f"state {bare['store'] / 2**20:.0f} MiB (f32: {bare['store f32'] / 2**20:.0f} MiB); "
            f"wire {bare['wire slim']:.1f} B/example slim, {bare['wire full']:.1f} full; host "
            f"encode {bare['encode ms']:.2f} ms a batch; {res['step']} steps on {card}")
    for phase in ("1", "2", "3", "4", "4b", "5", "6", "7", "8"):
        log(f"phase {phase}: {PHASE_S[phase]:.1f} s")
    log(f"all phases: {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
