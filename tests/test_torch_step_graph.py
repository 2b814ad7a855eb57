"""The lazy-sparse step replayed from CUDA graphs (train/step_graph.py).

On the CPU: Adam's bias corrections computed on the device hold, bit for
bit, the scalars the updates divided by before, and a step being captured
advances their device count; a stub graph stands in for
the CUDA one (its capture runs the step, its replay runs nothing) to
check the dispatch: one graph a batch signature, the first call eager,
capture then replay, each eager reason, the counts in the optimizer
state and the launch counters advancing once a step, a loss of each
call's own, a state dict not seen before, a failed capture; traced replays hand
the span recorder whole step trees with the graph's events; the
benchmark's graph_step_share reader. Marked ``cuda`` (they skip here):
graph and eager trajectories bit-identical on the card over 12 steps of
DeepFM and DIN with a bucket change, and a traced replay's step tree
and kernel calls under torch.profiler."""

import importlib.util
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tf_repos_tpu_torch.config import Config
from tf_repos_tpu_torch.data import sparse_batch as SB
from tf_repos_tpu_torch.data import synthetic as TS
from tf_repos_tpu_torch.data.ragged import MH_PAIRS
from tf_repos_tpu_torch.models import create_model
from tf_repos_tpu_torch.ops import sparse_rows as SR
from tf_repos_tpu_torch.ops.sparse_rows import make_expand_lookup
from tf_repos_tpu_torch.train import optimizers as OPT
from tf_repos_tpu_torch.train import sparse as SP
from tf_repos_tpu_torch.train import step_graph as SG
from tf_repos_tpu_torch.train.optimizers import make_optimizer
from tf_repos_tpu_torch.utils import observability as O
from tf_repos_tpu_torch.utils.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-2
DEEPFM = dict(model="DeepFM", feature_size=400, field_size=10, embedding_size=4,
              deep_layers="16,8", dropout="1.0,1.0", batch_size=32, l2_reg=1e-4,
              learning_rate=LR, static_fields=3)
DIN = dict(model="DIN", feature_size=400, field_size=11, embedding_size=4, deep_layers="8,4",
           attention_layers="8", dropout="1.0,1.0", batch_size=16, l2_reg=1e-4,
           learning_rate=LR, multi_hot_pad=64)
DIN_LENS = {k: v / 25 for k, v in TS.PUBLISHED_MH_AVG_LENS.items()}
STEP_SPANS = {"deepfm": 11, "din": 12}  # records in one step tree (test_torch_spans.STEP_TREE)
_REAL_SIGNATURE = SG.signature


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
    """Histories that grow along the run, so the pow2 buckets change."""
    rng = np.random.default_rng(seed)
    return [TS.synthetic_aliccp_batch(rng, 16, 400, multi_hot_pad=64,
                                      avg_lens={k: v * (1 + 3 * i // n) for k, v in DIN_LENS.items()},
                                      zipf_a=1.2)
            for i in range(n)]


def _setup(which, n=3, device="cpu", catchup=False):
    """A lazy-sparse Adam step on the fused store (the benchmark's flags:
    DIN under --mh_coo --mh_bucket=pow2 with the compact stream) and
    ``n`` mapped batches on ``device``; the same weights every call."""
    cfg = Config(**(DEEPFM if which == "deepfm" else DIN))
    model = create_model(cfg)
    params, mstate = model.init(torch.Generator().manual_seed(0))
    params, mstate = _to(params, device), _to(mstate, device)
    tx = make_optimizer("Adam", LR)
    sopt = SP.make_sparse_row_optimizer("Adam", LR, fused_table=True, catchup=catchup)
    opt = SP.init_opt_state(model, tx, sopt, params)
    step = SP.build_sparse_train_step(model, tx, sopt, lookup=make_expand_lookup())
    if which == "deepfm":
        raw, chain = _deepfm_batches(n), [SB.SparseBatchMapper(model.sparse_slots())]
    else:
        raw = _din_batches(n)
        chain = [SB.MhPadBucketer(MH_PAIRS, "pow2"),
                 SB.MhCooPacker(model.mh_coo_groups(), floor=1024, cdest_aux=True),
                 SB.SparseBatchMapper(model.sparse_slots())]
    batches = []
    for b in raw:
        b = dict(b)
        for stage in chain:
            b = stage(b)
        batches.append({k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                        for k, v in b.items()})
    return step, [params, opt, mstate], batches


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree


def _run(step, state, batches, **kw):
    losses = []
    for b in batches:
        state[0], state[1], state[2], loss = step(*state, b, **kw)
        losses.append(loss)
    return losses


class StubGraph:
    """CudaGraph stood in for on the CPU: ``capture`` runs the step (a
    CUDA capture only records it), ``replay`` runs nothing; both count."""

    made = []

    def __init__(self, pool):
        self.replays, self.captured = 0, 0
        StubGraph.made.append(self)

    def capture(self, fn):
        self.captured += 1
        return fn()

    def replay(self):
        self.replays += 1

    @staticmethod
    def new_pool():
        return "pool"


def _cpu_signature(batch):
    return tuple((k, tuple(v.shape), v.dtype, -1) for k, v in batch.items())


@pytest.fixture
def stub(monkeypatch):
    StubGraph.made = []
    monkeypatch.setattr(SG.GraphedStep, "Graph", StubGraph)
    monkeypatch.setattr(SG, "signature", _cpu_signature)
    monkeypatch.setattr(SG, "TRACED_COPIES", 1)  # one traced graph a signature, as untraced
    O.STEP_LOG.take()
    O.RECORDER.clear()
    yield StubGraph
    O.STEP_LOG.take()
    O.RECORDER.clear()


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return O.STEP_LOG.take()


# ------------------------------------------------------------ the corrections
def _correction(b, t):
    """1 - b^t as the lazy row update computed it on the host: powf of
    0-d f32 tensors (a tensor exponent, not torch's repeated products)."""
    f32 = torch.float32
    return (1.0 - torch.pow(torch.tensor(b, dtype=f32), torch.tensor(float(t), dtype=f32))).item()


def test_correction_tables_hold_the_scalars_bit_for_bit():
    cpu, f32 = torch.device("cpu"), torch.float32
    lazy = SP.make_sparse_row_optimizer("Adam", LR, fused_table=True).steps
    dense = make_optimizer("Adam", LR).steps
    aux, state = {"t": 0}, {"count": 0}
    for t in range(1, 4097):
        got_t, c = lazy.advance(aux, "t", cpu)
        want = torch.tensor([_correction(0.9, t), _correction(0.999, t)], dtype=torch.float64)
        assert got_t == t == aux["t"] and c.dtype == f32 and torch.equal(c, want.to(f32)), t
        # the dense update divided by optax's Python scalar, rounded to f32
        got_t, c = dense.advance(state, "count", cpu)
        want = torch.tensor([1.0 - 0.9 ** t, 1.0 - 0.999 ** t]).to(f32)
        assert got_t == t == state["count"] and torch.equal(c, want), t


def test_a_captured_step_advances_the_device_count(monkeypatch):
    """An eager step fills the count's copy with t; a step being captured
    adds one to it, so each replay reads its own t; a capture before any
    eager step of the state refuses."""
    cpu = torch.device("cpu")
    corr = OPT.BiasCorrections(0.9, 0.999, torch.float32)
    state = {"t": 0}
    corr.advance(state, "t", cpu)  # eager: the copy holds 1
    monkeypatch.setattr(OPT, "_capturing", lambda device: True)
    for t in range(2, 6):  # each "replay" of the captured add
        _, c = corr.advance(state, "t", cpu)
        assert state["t"] == t and torch.equal(c, corr_at(t))
    with pytest.raises(RuntimeError, match="step eagerly first"):
        corr.advance({"t": 0}, "t", cpu)
    monkeypatch.setattr(OPT, "_capturing", lambda device: False)
    state["t"] = 40  # a count set from outside: the next eager step refills the copy
    _, c = corr.advance(state, "t", cpu)
    assert torch.equal(c, corr_at(41))


def corr_at(t):
    return torch.tensor([_correction(0.9, t), _correction(0.999, t)],
                        dtype=torch.float64).to(torch.float32)


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("which", ["deepfm", "din"])
def test_one_graph_a_signature_the_first_call_eager(stub, which):
    step, state, batches = _setup(which, n=6)
    sigs = [_cpu_signature(b) for b in batches]
    order = batches + batches[::-1]
    how = _profiled(lambda: _run(step, state, order))
    assert len(set(sigs)) >= (2 if which == "din" else 1)
    assert how[0] == "eager: first call" and how[1:] == ["graph"] * (len(order) - 1)
    # each signature is captured where it comes first after the eager call
    captured = {_cpu_signature(b) for b in order[1:]}
    assert len(stub.made) == len(captured)
    assert step.counts == {"eager": 1, "capture": len(captured),
                           "replay": len(order) - 1 - len(captured)}
    assert all(g.captured == 1 for g in stub.made)
    assert sum(g.replays for g in stub.made) == len(order) - 1
    # every count advanced exactly once a step, the captures' included
    assert state[1]["dense"]["count"] == len(order)
    assert all(aux["t"] == len(order) for aux in state[1]["sparse"].values())


def test_a_loss_of_each_calls_own(stub):
    step, state, batches = _setup("deepfm", n=1)
    losses = _run(step, state, batches * 4)
    static = next(iter(step._graphs.values())).loss
    assert all(loss is not static and loss.data_ptr() != static.data_ptr() for loss in losses[1:])
    assert len({loss.data_ptr() for loss in losses[1:]}) == 3


@pytest.mark.parametrize("reason", ["generator", "sr_generator", "cpu tensors", "catch-up"])
def test_each_eager_reason(stub, monkeypatch, reason):
    step, state, batches = _setup("deepfm", n=3, catchup=reason == "catch-up")
    kw = {}
    if reason == "generator":
        kw["generator"] = torch.Generator().manual_seed(1)
    elif reason == "sr_generator":
        kw["sr_generator"] = torch.Generator().manual_seed(1)
    elif reason == "cpu tensors":
        monkeypatch.setattr(SG, "signature", _REAL_SIGNATURE)
    how = _profiled(lambda: _run(step, state, batches, **kw))
    assert how == ["eager: " + reason] * 3 and stub.made == []
    assert step.counts == {"eager": 3, "capture": 0, "replay": 0}
    assert state[1]["dense"]["count"] == 3


def test_new_state_and_changed_counts_run_eagerly(stub):
    step, state, batches = _setup("deepfm", n=1)
    how = _profiled(lambda: _run(step, state, batches * 3))
    assert how == ["eager: first call", "graph", "graph"]
    state[1]["dense"]["count"] += 5  # a count set from outside (a restore)
    how = _profiled(lambda: _run(step, state, batches * 2))
    assert how == ["eager: counts changed", "graph"] and len(stub.made) == 1
    _, fresh, _ = _setup("deepfm", n=1)
    state = fresh
    how = _profiled(lambda: _run(step, state, batches * 2))
    assert how == ["eager: new state", "graph"] and len(stub.made) == 2  # dropped, captured anew


def test_a_state_dict_not_seen_before_runs_eagerly(stub):
    """The same tensors in new optimizer-state dicts (the device copies of
    their counts are keyed by the dict, and a graph advances the copies
    it was captured with): that call runs eagerly, then the step captures
    anew and the counts advance in the new dicts."""
    step, state, batches = _setup("deepfm", n=1)
    _run(step, state, batches * 2)
    state[1] = dict(state[1], sparse={t: dict(a) for t, a in state[1]["sparse"].items()})
    how = _profiled(lambda: _run(step, state, batches * 3))
    assert how == ["eager: new state", "graph", "graph"]
    assert step.counts == {"eager": 2, "capture": 2, "replay": 1}
    assert state[1]["dense"]["count"] == 5
    assert all(aux["t"] == 5 for aux in state[1]["sparse"].values())


def test_a_failed_capture_leaves_the_signature_eager(stub, monkeypatch, capsys):
    class Failing(StubGraph):
        def capture(self, fn):
            fn()  # the step's Python advanced the counts before the failure
            raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(SG.GraphedStep, "Graph", Failing)
    step, state, batches = _setup("deepfm", n=1)
    before = SR.expand_rows.launches
    how = _profiled(lambda: _run(step, state, batches * 4))
    assert how == ["eager: first call"] + ["eager: capture failed"] * 3
    assert len(Failing.made) == 1  # tried once
    assert capsys.readouterr().out.count("WARNING: the training step runs eagerly") == 1
    assert state[1]["dense"]["count"] == 4
    assert SR.expand_rows.launches == before  # the CPU's plain lookup counts none


def test_replays_add_the_launches_and_counts_of_the_capture(stub):
    def fake(params, opt, mstate, batch, generator=None, sr_generator=None):
        SR.accumulate_rows.launches += 2
        SR.expand_rows.launches += 1
        opt["count"] += 1
        opt["inner"]["t"] += 3
        return params, opt, mstate, batch["x"].sum()

    step = SG.GraphedStep(fake)
    params, opt = {"w": torch.zeros(3)}, {"count": 0, "inner": {"t": 0, "k": 7}}
    acc, exp = SR.accumulate_rows.launches, SR.expand_rows.launches
    batch = {"x": torch.arange(4.0)}
    for _ in range(5):
        step(params, opt, {}, batch)
    assert step.counts == {"eager": 1, "capture": 1, "replay": 3}
    assert SR.accumulate_rows.launches == acc + 10 and SR.expand_rows.launches == exp + 5
    assert opt == {"count": 5, "inner": {"t": 15, "k": 7}}


# ------------------------------------------------------------ traced replays
class _Clock:
    """CUDA timing events stood in for, external ones included: each
    records the clock's time."""

    def __init__(self):
        self.now, self.external, self.synced = 0.0, 0, 0
        clock = self

        class Event:
            def __init__(self, enable_timing=False, external=False):
                clock.external += external
                self.t = None

            def record(self):
                self.t = clock.now

            def query(self):
                return True

            def synchronize(self):
                clock.synced += 1

            def elapsed_time(self, end):
                return end.t - self.t

        self.Event = Event


def test_traced_replays_give_whole_step_trees(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", clock.Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(O, "RECORDER", O.SpanRecorder())

    def toy():
        with O.span("step", count=lambda: 8):
            clock.now += 0.5
            with O.span("step.gather"):
                clock.now += 1.0
            with O.span("step.forward", adjacent=True):
                clock.now += 2.0

    with profile(activities=[ProfilerActivity.CPU]):
        with O.span_template() as template:
            toy()  # the capture: nothing reaches the recorder
        assert O.RECORDER.records() == []
        step, gather, forward = template._recs
        assert forward.start_ev is gather.end_ev
        last = None
        for i in range(3):
            O.RECORDER.settle(last)  # the last replay's events are read first
            clock.now = 10.0 * i  # a replay records the graph's events anew
            step.start_ev.record()
            clock.now += 0.5
            gather.start_ev.record()
            clock.now += 1.0
            gather.end_ev.record()
            clock.now += 2.0
            forward.end_ev.record()
            step.end_ev.record()
            last = O.RECORDER.replayed(template, 0, 1)
    assert clock.external == 5  # the step's two, the gather's two, the forward's end
    recs = O.RECORDER.records()
    assert [r["name"] for r in recs] == ["step", "step.gather", "step.forward"] * 3
    assert [r["parent"] for r in recs] == [None, 0, 0, None, 3, 3, None, 6, 6]
    assert len({r["step"] for r in recs}) == 3
    assert O.span_ms_per_step(recs) == {"step": 3.5, "step.gather": 1.0, "step.forward": 2.0}
    assert clock.synced == 2
    O.RECORDER.clear()
    assert O.RECORDER._pool == []  # a graph's events never go to the pool


@pytest.mark.parametrize("which", ["deepfm", "din"])
def test_traced_copies_in_turn_record_a_step_tree_a_call(stub, which, monkeypatch):
    monkeypatch.setattr(SG, "TRACED_COPIES", 3)
    step, state, batches = _setup(which, n=2)
    _run(step, state, batches[:1] * 2)  # eager, then the untraced graph
    with profile(activities=[ProfilerActivity.CPU]):
        _run(step, state, batches[:1] * 7)
    recs = O.RECORDER.records()
    assert sum(r["name"] == "step" for r in recs) == 7
    assert len(recs) == 7 * STEP_SPANS[which]
    # the untraced graph, then three traced copies replayed in turn
    assert len(stub.made) == 4 and [g.replays for g in stub.made] == [1, 3, 2, 2]
    assert len({id(g) for g in stub.made}) == 4
    assert len(step._buffers) == 1  # the signature's graphs share its static batch
    assert O.STEP_LOG.take() == ["graph"] * 7


# ------------------------------------------------------------ the reader
def _reader():
    path = os.path.join(ROOT, "benchmark", "metrics", "graph_step_share.train.py")
    spec = importlib.util.spec_from_file_location("graph_step_share_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Trace:
    def __init__(self, steps, device_ops=(("k", 0.0, 1.0),)):
        self.steps, self.device_ops = steps, list(device_ops)


def test_graph_step_share_reads_the_windows_steps(stub):
    reader = _reader()
    assert reader.UNIT == "%"
    O.STEP_LOG._entries = ["graph"] * 3 + ["eager: capture failed"] + ["eager: generator"] * 5
    assert reader.read(_Trace(4)) == pytest.approx(75.0)
    assert O.STEP_LOG.take() == []  # read once, then emptied
    O.STEP_LOG._entries = ["graph"] * 3
    assert reader.read(_Trace(4)) is None  # fewer entries than steps
    O.STEP_LOG._entries = ["graph"] * 3
    assert reader.read(_Trace(3, device_ops=())) is None  # nothing ran on a card
    assert reader.read(_Trace(0)) is None


def test_the_log_records_only_under_a_profiler(stub):
    step, state, batches = _setup("deepfm", n=1)
    _run(step, state, batches * 3)
    assert O.STEP_LOG.take() == []


# ------------------------------------------------------------ on the card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["deepfm", "din"])
def test_graph_and_eager_trajectories_are_bit_identical(dev, which):
    n = 12
    step, graphed, batches = _setup(which, n=n, device=dev)
    plain, eager, _ = _setup(which, n=n, device=dev)
    force = torch.Generator(device=dev)  # keep 1 everywhere: it draws nothing, the step stays eager
    sigs = [SG.signature(b) for b in batches]
    assert len(set(sigs)) >= (2 if which == "din" else 1)
    for b in batches:
        graphed[0], graphed[1], graphed[2], lg = step(*graphed, b)
        eager[0], eager[1], eager[2], le = plain(*eager, b, generator=force)
        assert torch.equal(lg, le)
    assert step.counts["capture"] == len(set(sigs[1:])) and step.counts["replay"] > 0
    assert plain.counts["eager"] == n
    for a, b in zip(tree_leaves(graphed), tree_leaves(eager)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["deepfm", "din"])
def test_a_traced_replay_gives_the_step_tree_and_one_call_a_kernel(dev, which, monkeypatch):
    step, state, batches = _setup(which, n=1, device=dev)
    _run(step, state, batches * 2)  # eager, then the untraced graph
    calls = {"expand_rows": 0, "accumulate_rows": 0}
    for name in calls:
        orig = getattr(SR, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        counted.launches = orig.launches
        monkeypatch.setattr(SR, name, counted)
    O.RECORDER.clear()
    n = SG.TRACED_COPIES + 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        _run(step, state, batches * n)
        torch.cuda.synchronize()
    # one call of each entry a traced copy's capture, none from a replay
    lookups = SG.TRACED_COPIES * (1 if which == "deepfm" else 2)  # DIN: the fields and the slots
    assert calls == {"expand_rows": lookups, "accumulate_rows": lookups}
    recs = O.RECORDER.records()
    O.RECORDER.clear()
    assert sum(r["name"] == "step" for r in recs) == n and len(recs) == n * STEP_SPANS[which]
    assert all(r["device_ms"] is not None and r["device_ms"] >= 0 for r in recs)
    assert O.STEP_LOG.take() == ["graph"] * n
