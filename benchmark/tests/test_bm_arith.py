"""The FLOP and byte counts at the cells' shapes against hand-worked
values, and the readers' arithmetic on a made-up trace."""

import numpy as np
import pytest
import torch

from benchmark import metrics as M
from benchmark import spec
from benchmark.reference import deepfm, din
from benchmark.trace import Trace

READERS = M.load_all()


def test_deepfm_step_flops_at_b128k():
    cfg = spec.load_json("configs", "deepfm_criteo")
    raw = {"feat_ids": np.zeros((131072, 39), np.int32)}
    # towers 1248-256-128-64-1: 2 * (319,488 + 32,768 + 8,192 + 64) = 721,024;
    # FM: 2 * 39 + 4 * 39 * 32 + 3 * 32 = 5,166; forward + backward = 3x
    assert deepfm.step_flops(cfg, raw) == 3 * 131072 * (721_024 + 5_166)


def test_din_step_flops_counts_live_slots():
    cfg = spec.load_json("configs", "din_aliccp")
    b = 4096
    raw = {"feat_ids": np.zeros((b, 11), np.int32), "a_intids": np.zeros((b, 8), np.int32)}
    for f in din.USER_FIELDS:
        raw[f"{f}ids"] = np.zeros((b, 512), np.int32)
    raw["u_shopids"][:, :250] = 7  # 1,024,000 live slots
    raw["a_intids"][:, :2] = 3  # 8,192 live a_int slots
    # towers 608-256-128-64-1: 2 * (155,648 + 32,768 + 8,192 + 64) = 393,344;
    # attention 96-256-1: 2 * (24,576 + 256) = 49,664, + 3 * 32 + 1 elementwise
    want = 3 * (b * 393_344 + 1_024_000 * (49_664 + 97) + 8_192 * 64)
    assert din.step_flops(cfg, raw) == want


def test_k2_bytes_at_the_deepfm_cell():
    r = READERS["K2_roofline"]
    n, s = 131072 * 26, 117_582  # the categorical slots; every row of the store at most
    g = torch.empty((n, 33))
    nbytes, adds = r._launch(g, torch.empty(n, dtype=torch.int32), s)
    assert nbytes == 3_407_872 * 33 * 4 + 3_407_872 * 4 + s * 33 * 4 == 478_991_416
    assert adds == 112_459_776
    assert r.least_seconds([(nbytes, adds)]) == pytest.approx(478_991_416 / 3.35e12)


def test_k5_k6_bytes_at_the_din_cell():
    r = READERS["K5_K6_roofline"]
    m, g = 1_310_720, 16_384
    vals, cdest = torch.empty((m, 32)), torch.empty(m, dtype=torch.int32)
    f5 = r.ENTRIES[("tf_repos_tpu_torch.ops.sorted_seg", "sorted_segsum")]
    f6 = r.ENTRIES[("tf_repos_tpu_torch.ops.sorted_seg", "sorted_expand")]
    # the M value rows and ids read and the G rows written, once each
    assert f5(vals, cdest, g) == (m * 128 + m * 4 + g * 128, m * 32) == (175_112_192, 41_943_040)
    assert f6(torch.empty((g, 32)), cdest)[0] == g * 128 + m * 4 + m * 128 == 175_112_192


def made_up_trace(**kw):
    base = dict(window_s=1.0, steps=4, model_flops=989e9,
                device_ops=[("accumulate_rows_kernel<float>", 0.0, 0.25), ("gemm", 0.1, 0.3),
                            ("accumulate_rows_kernel<float>", 0.5, 0.75), ("Memcpy HtoD", 0.8, 0.85)],
                host_ops=[("aten::mm", 0.29, 0.6), ("aten::add", 0.76, 0.9)],
                calls={("tf_repos_tpu_torch.ops.sparse_rows", "accumulate_rows"): [(3.35e9, 0)] * 2})
    base.update(kw)
    return Trace(**base)


def test_readers_on_a_made_up_trace():
    tr = made_up_trace()
    # busy: [0, 0.3] + [0.5, 0.75] + [0.8, 0.85] = 0.6 (the sum would be 0.75)
    assert READERS["device_idle_share.train"].read(tr) == pytest.approx(40.0)
    assert READERS["device_ops_per_step.train"].read(tr) == 1.0
    assert READERS["step_mfu.train"].read(tr) == pytest.approx(0.1)
    # each launch's least time 1 ms against 250 ms
    assert READERS["K2_roofline"].read(tr) == pytest.approx(0.4)
    assert READERS["K5_K6_roofline"].read(tr) is None
    gaps = dict(map(tuple, tr.idle_gaps()))
    assert gaps == pytest.approx({"aten::mm": 0.2, "aten::add": 0.05, "no host operation": 0.15})
    assert tr.top_device_ops()[0] == ["accumulate_rows_kernel<float>", 0.5]


def test_readers_find_nothing_in_an_empty_trace():
    tr = made_up_trace(device_ops=[], calls={})
    assert all(r.read(tr) is None for r in READERS.values())
