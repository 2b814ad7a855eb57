"""The port's spans (utils/observability.span) on the CPU, on tiny DeepFM
and DIN lazy-sparse steps: with no profiler active nothing is recorded,
no hook is registered and the steps are bitwise those of a profiled run;
under a profiler one step gives the span tree the step and the models
declare, with the backward halves under the step's backward; the
recorder stops at its bound and counts what it drops; on a card (CUDA
events stood in for by a clock the test moves) a span that opens where
the one before it closed shares its event, and the events of the steps
the device has passed go back to the pool, so a run builds them only in
its first step; profile_trace's summary line reads the step trees by
device ms a step, their counts by device ms, and input.wait by host ms."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data import sparse_batch as SB
from tf_repos_tpu_torch.data import synthetic as TS
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils import observability as O
from tf_repos_tpu_torch.utils.tree import tree_leaves

LR = 1e-2
DEEPFM = dict(model="DeepFM", feature_size=400, field_size=10, embedding_size=4,
              deep_layers="16,8", dropout="1.0,1.0", batch_size=32, l2_reg=1e-4,
              learning_rate=LR, static_fields=3)
DIN = dict(model="DIN", feature_size=400, field_size=11, embedding_size=4, deep_layers="8,4",
           attention_layers="8", dropout="1.0,1.0", batch_size=16, l2_reg=1e-4,
           learning_rate=LR, multi_hot_pad=8)
DIN_LENS = {k: v / 25 for k, v in TS.PUBLISHED_MH_AVG_LENS.items()}

# the span tree of one step: (name, parent's name), in the order they open
STEP_TREE = {
    "deepfm": [
        ("step", None), ("step.gather", "step"), ("step.forward", "step"),
        ("model.embed", "step.forward"), ("model.fm", "step.forward"),
        ("model.towers", "step.forward"), ("step.backward", "step"),
        ("model.towers.bwd", "step.backward"), ("model.fm.bwd", "step.backward"),
        ("model.embed.bwd", "step.backward"), ("step.update", "step"),
    ],
    "din": [
        ("step", None), ("step.gather", "step"), ("step.forward", "step"),
        ("model.embed", "step.forward"), ("model.embed", "step.forward"),
        ("model.attention", "step.forward"), ("model.towers", "step.forward"),
        ("step.backward", "step"), ("model.towers.bwd", "step.backward"),
        ("model.attention.bwd", "step.backward"), ("model.embed.bwd", "step.backward"),
        ("step.update", "step"),
    ],
}
MODEL_SPANS = {"model.embed", "model.fm", "model.attention", "model.towers"}


def _deepfm_batches(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        z = np.minimum(rng.zipf(1.2, size=(32, 10)), 399).astype(np.int32)
        z[:, :3] = np.arange(1, 4)
        out.append({"feat_ids": z, "feat_vals": rng.random((32, 10)).astype(np.float32),
                    "label": (rng.random(32) < 0.5).astype(np.float32),
                    "mask": np.ones(32, np.float32)})
    return out


def _din_batches(n, seed=12):
    rng = np.random.default_rng(seed)
    return [TS.synthetic_aliccp_batch(rng, 16, 400, multi_hot_pad=8, avg_lens=DIN_LENS, zipf_a=1.2)
            for _ in range(n)]


def _setup(which, n=3):
    """A fresh lazy-sparse Adam step on the fused store (the benchmark's
    flags: --mh_coo with the compact stream for DIN) and ``n`` mapped
    batches; the same weights every call."""
    cfg = Config(**(DEEPFM if which == "deepfm" else DIN))
    model = create_model(cfg)
    params, mstate = model.init(torch.Generator().manual_seed(0))
    tx = make_optimizer("Adam", LR)
    sopt = SP.make_sparse_row_optimizer("Adam", LR, fused_table=True)
    opt = SP.init_opt_state(model, tx, sopt, params)
    step = SP.build_sparse_train_step(model, tx, sopt, lookup=make_expand_lookup())
    if which == "deepfm":
        raw, chain = _deepfm_batches(n), [SB.SparseBatchMapper(model.sparse_slots())]
    else:
        raw = _din_batches(n)
        chain = [SB.MhCooPacker(model.mh_coo_groups(), cdest_aux=True),
                 SB.SparseBatchMapper(model.sparse_slots(), "pow2:400")]
    batches = []
    for b in raw:
        b = dict(b)
        for stage in chain:
            b = stage(b)
        batches.append({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in b.items()})
    return step, [params, opt, mstate], batches


def _run(step, state, batches):
    losses = []
    for b in batches:
        state[0], state[1], state[2], loss = step(*state, b)
        losses.append(loss)
    return losses


@pytest.fixture(autouse=True)
def empty_recorder():
    O.RECORDER.clear()
    yield
    O.RECORDER.clear()


@pytest.mark.parametrize("which", ["deepfm", "din"])
def test_no_profiler_no_record_no_hook(which, monkeypatch):
    step, state, batches = _setup(which)
    calls = []
    hook = torch.Tensor.register_hook
    monkeypatch.setattr(torch.Tensor, "register_hook",
                        lambda t, fn: calls.append("hook") or hook(t, fn))
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        lambda *a, **k: calls.append("multi"))
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: calls.append("event"))
    monkeypatch.setattr(O.RECORDER, "open", lambda *a, **k: calls.append("record"))
    monkeypatch.setattr(O._BackwardHalf, "watch", lambda *a, **k: calls.append("watch"))
    monkeypatch.setattr(SP, "batch_rows", lambda *a: calls.append("count"))
    assert O.span("step") is O.span("model.fm")  # the one shared no-op
    _run(step, state, batches)
    assert calls == [] and O.RECORDER.records() == [] and O.RECORDER.dropped == 0


@pytest.mark.parametrize("which", ["deepfm", "din"])
def test_steps_are_bitwise_those_of_a_profiled_run(which):
    step, plain, batches = _setup(which)
    want = _run(step, plain, batches)
    step, traced, batches = _setup(which)
    with profile(activities=[ProfilerActivity.CPU]):
        got = _run(step, traced, batches)
    assert len(O.RECORDER.records()) == len(batches) * len(STEP_TREE[which])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(traced), tree_leaves(plain)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.parametrize("which", ["deepfm", "din"])
def test_one_step_gives_the_span_tree(which):
    step, state, batches = _setup(which, n=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(step, state, batches)
    recs = O.RECORDER.records()
    names = [r["name"] for r in recs]
    assert [(n, None if r["parent"] is None else names[r["parent"]])
            for n, r in zip(names, recs)] == STEP_TREE[which]
    assert all(r["parent"] is None or r["parent"] < i for i, r in enumerate(recs))
    assert len({r["step"] for r in recs}) == 1 and recs[0]["step"] is not None
    rows = batches[0]["label"].shape[0]
    assert recs[0]["count"] == rows
    u = {t: int(v.shape[0]) for t, v in batches[0].items() if t.startswith(SB.UIDS_PREFIX)}
    assert recs[-1]["count"] == {t[len(SB.UIDS_PREFIX):]: n for t, n in u.items()}
    if which == "din":
        att = names.index("model.attention")
        assert recs[att]["count"] == batches[0][SB.MHC_IDX].numel()
    by = {n: r for n, r in zip(names, recs)}
    for r in recs:  # closed, inside the parent, with a device extent (the host's on the CPU)
        assert r["end_ns"] >= r["start_ns"] and r["device_ms"] >= 0
        if r["parent"] is not None:
            p = recs[r["parent"]]
            assert p["start_ns"] <= r["start_ns"] and r["end_ns"] <= p["end_ns"]
    # the halves one after another, not over each other
    halves = sorted((r for r in recs if r["name"].endswith(".bwd")), key=lambda r: r["start_ns"])
    assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(halves, halves[1:]))
    fwd_bwd = by["step.forward"]["device_ms"] + by["step.backward"]["device_ms"]
    assert sum(r["device_ms"] for r in recs if r["name"].removesuffix(".bwd") in MODEL_SPANS) <= fwd_bwd
    # the record_function ranges are in the profiler's own trace
    traced = {e.name for e in prof.events()}
    assert {n for n, _ in STEP_TREE[which] if not n.endswith(".bwd")} <= traced


def test_the_recorder_stops_at_its_bound(monkeypatch):
    step, state, batches = _setup("deepfm", n=2)
    monkeypatch.setattr(O.RECORDER, "limit", 5)
    with profile(activities=[ProfilerActivity.CPU]):
        _run(step, state, batches)
    recs = O.RECORDER.records()
    assert [r["name"] for r in recs] == [n for n, _ in STEP_TREE["deepfm"][:5]]
    assert O.RECORDER.dropped == 2 * len(STEP_TREE["deepfm"]) - 5
    O.RECORDER.clear()
    assert O.RECORDER.records() == [] and O.RECORDER.dropped == 0


def test_ms_per_step_over_the_step_records():
    recs = [{"name": "step", "step": 1, "device_ms": 4.0},
            {"name": "step.forward", "step": 1, "device_ms": 1.0},
            {"name": "model.fm", "step": None, "device_ms": 9.0},  # an eval forward
            {"name": "step", "step": 2, "device_ms": 6.0},
            {"name": "step.forward", "step": 2, "device_ms": 3.0},
            {"name": "step.update", "step": 2, "device_ms": None},  # still open
            {"name": "input.wait", "step": None, "device_ms": 0.5}]
    assert O.span_ms_per_step(recs) == {"step": 5.0, "step.forward": 2.0}
    assert O.span_ms_per_step(recs, 1) == {"step": 4.0, "step.forward": 1.0}
    assert O.span_ms_per_step(recs[-1:]) == {}


def test_summary_line_reads_the_step_trees_their_counts_and_the_input_wait():
    ms = 1_000_000
    recs = [{"name": "input.wait", "parent": None, "step": None, "count": None,
             "start_ns": 0, "end_ns": 3 * ms, "device_ms": 0.01},
            {"name": "step", "parent": None, "step": 1, "count": 100,
             "start_ns": 3 * ms, "end_ns": 9 * ms, "device_ms": 2.0},
            {"name": "model.attention", "parent": 0, "step": 1, "count": 40,
             "start_ns": 4 * ms, "end_ns": 5 * ms, "device_ms": 0.5},
            {"name": "step.update", "parent": 0, "step": 1, "count": {"emb": 6, "w": 4},
             "start_ns": 5 * ms, "end_ns": 6 * ms, "device_ms": 0.25},
            {"name": "model.fm", "parent": None, "step": None, "count": None,
             "start_ns": 9 * ms, "end_ns": 10 * ms, "device_ms": 7.0}]  # an eval forward
    line = O.span_summary(recs)
    assert line == ("device ms a step [count a device ms] over 1 steps: model.attention 0.5000 "
                    "[80.0], step 2.0000 [50.0], step.update 0.2500 [40.0]; host ms a call "
                    "outside the steps: input.wait 3.0000 (x1), model.fm 1.0000 (x1)")
    assert O.span_summary([]) == ""


class _Clock:
    """CUDA timing events stood in for: each records the clock's time;
    the device has reached them while ``reached``."""

    def __init__(self):
        self.now, self.made, self.recorded, self.reached = 0.0, 0, 0, True
        clock = self

        class Event:
            def __init__(self, enable_timing=False):
                clock.made += 1
                self.t = None

            def record(self):
                clock.recorded += 1
                self.t = clock.now

            def query(self):
                return clock.reached

            def elapsed_time(self, end):
                if not clock.reached:
                    raise RuntimeError("device not ready")
                return end.t - self.t

        self.Event = Event


@pytest.fixture
def card(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", clock.Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(O, "RECORDER", O.SpanRecorder())  # its own pool
    return clock


def _toy_steps(clock, n):
    """``n`` steps of the step's shape: gather, forward, update, the last
    two adjacent, the forward 2 ms on the device, the others 1."""
    for _ in range(n):
        with O.span("step", count=lambda: 8):
            clock.now += 0.5  # between the step's open and the gather's
            with O.span("step.gather"):
                clock.now += 1.0
            with O.span("step.forward", adjacent=True):
                clock.now += 2.0
            with O.span("step.update", adjacent=True):
                clock.now += 1.0


def test_adjacent_spans_share_an_event_and_the_pool_refills_each_step(card):
    with profile(activities=[ProfilerActivity.CPU]):
        _toy_steps(card, 5)
    # 6 events a step (not 8), all of them made in the first step
    assert card.recorded == 5 * 6 and card.made == 6
    recs = O.RECORDER.records()
    assert card.made == 6
    assert O.span_ms_per_step(recs) == {"step": 4.5, "step.gather": 1.0, "step.forward": 2.0,
                                        "step.update": 1.0}
    assert [r["count"] for r in recs if r["name"] == "step"] == [8] * 5
    O.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _toy_steps(card, 2)
    assert card.made == 6  # the pool outlives the clear


def test_events_the_device_has_not_reached_are_read_after_a_sync(card):
    card.reached = False
    with profile(activities=[ProfilerActivity.CPU]):
        _toy_steps(card, 3)
    assert card.made == 3 * 6  # none came back while the device lagged
    card.reached = True
    assert O.span_ms_per_step(O.RECORDER.records())["step.forward"] == 2.0
    O.RECORDER.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _toy_steps(card, 3)
    assert card.made == 3 * 6


def test_an_adjacent_span_after_another_open_has_its_own_event(card):
    with profile(activities=[ProfilerActivity.CPU]):
        with O.span("step"):
            with O.span("step.gather"):
                card.now += 1.0
            card.now += 3.0  # launched between: the forward is not adjacent
            with O.span("step.forward"):
                with O.span("model.embed", adjacent=True):  # the forward opened since
                    card.now += 2.0
            with O.span("step.update", adjacent=True):
                card.now += 1.0
        # after the step: its close was resolved and pooled, so no event to share
        with O.span("input.wait", adjacent=True):
            card.now += 1.0
    by = {r["name"]: r["device_ms"] for r in O.RECORDER.records()}
    assert by == {"step": 7.0, "step.gather": 1.0, "step.forward": 2.0, "model.embed": 2.0,
                  "step.update": 1.0, "input.wait": 1.0}
    assert card.made == 2 * 5 - 1
