"""The port's host pipeline (tf_repos_tpu_torch/data/pipeline.py) on the
CPU: Prefetcher (order, an error that propagates, abandonment),
parallel_mapped_batches (order, exceptions, abandonment, re-pad
sentinels, the packer and mapper chain on several workers against the
sequential chain, a stress run with more workers than cores),
iter_dict_batches against the JAX package's on the same random stream,
and the harness with --map_workers against one worker (ESMM, and DIN
with the idx-sorted stream). Host arrays are held bit-exact; the
harness runs to 1e-5 relative on the loss and 1e-5 on the AUCs (the
same batches, pad widths that may differ)."""

import sys
import threading
import time

import numpy as np
import pytest

from tf_repos_tpu.data import pipeline as JP
from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data.pipeline import Prefetcher, iter_dict_batches, parallel_mapped_batches
from tf_repos_tpu_torch.data.sparse_batch import MhCooPacker, SparseBatchMapper
from tf_repos_tpu_torch.data.synthetic import synthetic_aliccp_batch, write_synthetic_aliccp
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.train.harness import Harness, run_task


# ---------------------------------------------------------------- Prefetcher
def test_prefetcher_orders_and_propagates():
    assert list(Prefetcher(iter(range(100)), size=4)) == list(range(100))

    def boom():
        yield 1
        raise RuntimeError("kaput")

    it = iter(Prefetcher(boom(), size=2))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="kaput"):
        next(it)


def test_prefetcher_abandoned_iterator_stops_worker():
    produced = []

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    before = threading.active_count()
    it = iter(Prefetcher(gen(), size=2))
    assert next(it) == 0
    it.close()  # abandon
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before, "prefetch thread leaked"
    assert len(produced) < 100  # it stopped producing, not just detached


# ------------------------------------------------- parallel_mapped_batches
def _xs(n):
    return [{"x": np.full((2,), i)} for i in range(n)]


def test_order_and_identity_map():
    out = list(parallel_mapped_batches(iter(_xs(20)), lambda: (lambda b: b), workers=4))
    assert [int(b["x"][0]) for b in out] == list(range(20))


def test_exception_propagates():
    def boom(b):
        if int(b["x"][0]) == 3:
            raise RuntimeError("boom")
        return b

    with pytest.raises(RuntimeError, match="boom"):
        list(parallel_mapped_batches(iter(_xs(8)), lambda: boom, workers=3))


def test_abandoned_iterator_joins_the_pool():
    before = threading.active_count()
    gen = parallel_mapped_batches((b for b in _xs(100)), lambda: (lambda b: b), workers=3)
    for i, _ in enumerate(gen):
        if i == 5:
            break
    gen.close()  # must join the pool without blocking
    assert threading.active_count() <= before


def test_repad_monotonic_with_sentinels():
    def batch(w):
        return {"u": np.arange(1, w + 1, dtype=np.int32), "v": np.ones((2, w), np.float32),
                "keep": np.arange(w)}

    out = list(parallel_mapped_batches(iter([batch(4), batch(8), batch(2)]), lambda: (lambda b: b),
                                       workers=2, pad_rules={"u": 99, "v": 0.0, "absent": 7}))
    assert [b["u"].shape[-1] for b in out] == [4, 8, 8]
    np.testing.assert_array_equal(out[2]["u"], [1, 2, 99, 99, 99, 99, 99, 99])
    np.testing.assert_array_equal(out[2]["v"], [[1, 1, 0, 0, 0, 0, 0, 0]] * 2)
    assert out[2]["keep"].shape == (2,)  # keys without a rule keep their width


def test_chain_instances_are_never_shared():
    """More workers than cores, a short switch interval: each chain
    instance is used by one thread at a time (its busy flag never seen
    set on entry) and every batch comes back once, in order."""

    class Chain:
        def __init__(self):
            self.busy = False
            self.calls = 0

        def __call__(self, b):
            assert not self.busy, "a chain instance was shared by two threads"
            self.busy = True
            self.calls += 1
            x = np.asarray(b["x"]).copy()
            for _ in range(3):
                x = x + 0  # numpy work between the flag's set and clear
            self.busy = False
            return {"x": x}

    chains = []

    def make():
        chains.append(Chain())
        return chains[-1]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.time()
        out = list(parallel_mapped_batches(iter(_xs(2000)), make, workers=16))
        assert time.time() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert [int(b["x"][0]) for b in out] == list(range(2000))
    assert len(chains) == 16 and sum(c.calls for c in chains) == 2000


def test_packer_mapper_chain_matches_sequential():
    cfg = Config(model="ESMM", feature_size=800, field_size=11, embedding_size=4, deep_layers="8,4",
                 dropout="1.0,1.0", batch_size=16, multi_hot_pad=8, sparse_table_update=True,
                 mh_coo=True, device="cpu")
    h = Harness(cfg)
    model = create_model(cfg)
    raw = [synthetic_aliccp_batch(np.random.default_rng(i), 16, 800, multi_hot_pad=8)
           for i in range(12)]

    def make():  # fixed floors: equal widths, so the batches must be bit-equal
        stages = [MhCooPacker(model.mh_coo_groups(), floor=256, combine=True),
                  SparseBatchMapper(model.sparse_slots(), pad_mode="pow2:64")]

        def chain(b):
            for s in stages:
                b = s(b)
            return b

        return chain

    seq_chain = make()
    seq = [seq_chain(dict(b)) for b in raw]
    par = list(parallel_mapped_batches(iter([dict(b) for b in raw]), make, workers=3,
                                       pad_rules=h._map_pad_rules()))
    assert len(par) == len(seq)
    for s, p in zip(seq, par):
        assert set(s) == set(p)
        for k in s:
            np.testing.assert_array_equal(s[k], p[k], err_msg=k)


# ------------------------------------------------------- iter_dict_batches
@pytest.mark.parametrize("wide", [False, True], ids=["row_permutation", "block_shuffle"])
@pytest.mark.parametrize("B", [8, 7])
def test_iter_dict_batches_matches_jax(wide, B):
    """Chunks of 37, 5 and 60 rows (a chunk smaller than a batch
    included); wide rows (1 MB) take the block shuffle."""
    width = 262144 if wide else 3

    def chunks():
        lo = 1
        for n in (37, 5, 60):
            yield {"y": np.arange(lo, lo + n, dtype=np.int64),
                   "w": np.zeros((n, width), np.int8) + np.int8(n % 7)}
            lo += n

    kw = dict(batch_size=B, row_key="y", shuffle=True)
    got = list(iter_dict_batches(chunks(), nprng=np.random.default_rng(4), **kw))
    want = list(JP.iter_dict_batches(chunks(), nprng=np.random.default_rng(4), **kw))
    assert len(got) == len(want) == -(-102 // B)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    rows = np.concatenate([b["y"] for b in got])
    np.testing.assert_array_equal(np.sort(rows[rows > 0]), np.arange(1, 103))  # every row once
    assert not np.array_equal(rows[:96], np.arange(1, 97))  # actually shuffled


def test_block_shuffle_keeps_every_row_when_a_chunk_holds_one_block():
    B, n = 8, 11  # B < n < 2B: the phase must leave one full block
    for seed in range(12):
        chunks = [{"y": np.arange(1, n + 1, dtype=np.int64), "wide": np.zeros((n, 262144), np.int8)}]
        rows = np.concatenate([b["y"] for b in iter_dict_batches(
            iter(chunks), batch_size=B, row_key="y", nprng=np.random.default_rng(seed), shuffle=True)])
        cnt = np.bincount(rows, minlength=n + 1)
        assert cnt[1:].min() == 1 and cnt[1:].max() == 1, (seed, rows)


# ------------------------------------------------------------ the harness
@pytest.mark.parametrize("model", ["ESMM", "DIN"])
def test_harness_map_workers_matches_one_worker(tmp_path, model):
    """--map_workers=3 against 1 through the harness: ESMM with the width
    bucketer before the packer (pad 16, true lengths 1..4, so the bucketer
    really slices) and the combine; DIN attention with the compact
    segment and idx-sorted streams (--coo_sorted_bwd), which the parallel
    chain re-pads."""
    d = tmp_path / "data"
    d.mkdir()
    write_synthetic_aliccp(str(d / "tr.samples.txt"), 200, feature_size=800, seed=0)
    write_synthetic_aliccp(str(d / "va.samples.txt"), 80, feature_size=800, seed=1)
    extra = (dict(mh_coo_combine=True) if model == "ESMM" else
             dict(attention_layers="8", pallas_expand=True, coo_sorted_bwd=True, fused_table=True))

    def run(workers):
        cfg = Config(model=model, feature_size=800, field_size=11, embedding_size=4,
                     deep_layers="8,4", dropout="1.0,1.0", batch_size=16, num_epochs=1,
                     log_steps=5, learning_rate=0.01, data_dir=str(d),
                     model_dir=str(tmp_path / f"m{workers}"), dt_dir="x", eval_throttle_secs=0,
                     seed=7, multi_hot_pad=16, sparse_table_update=True, mh_coo=True,
                     mh_bucket="pow2", map_workers=workers, compute_dtype="float32",
                     device="cpu", **extra)
        return run_task(cfg)

    one, three = run(1), run(3)
    assert one["step"] == three["step"] == 13
    np.testing.assert_allclose(three["loss"], one["loss"], rtol=1e-5)
    for k in one:
        if "AUC" in k or k == "auc":
            np.testing.assert_allclose(three[k], one[k], atol=1e-5)
