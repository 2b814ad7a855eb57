"""Observability (counterpart of the JAX package's utils/observability.py):
scalar metric events, profiler traces, NaN checks.

  MetricsWriter     append-only JSONL scalar events in model_dir, plus
                    TensorBoard event files (utils/tb_events.py) with the
                    same scalars under "<kind>/<name>" tags
  profile_trace     a torch.profiler trace (CPU, and CUDA when the run is
                    on a card) over a window of train steps, written by
                    torch.profiler.tensorboard_trace_handler as
                    <dir>/<worker>.<time>.pt.trace.json (Chrome trace
                    format; TensorBoard's profiler plugin reads it)
  enable_nan_checks --check_numerics, the port's jax_debug_nans: wraps a
                    train step so that a step that produces a NaN raises
                    FloatingPointError instead of carrying on
  span              a named region of the step or the model, traced only
                    while a torch.profiler profile is active: a
                    record_function range in the profiler's trace and a
                    record in RECORDER (host times, the device extent
                    from pooled CUDA events, the step it belongs to, a
                    work count); its backward half, ``<name>.bwd``, from
                    gradient hooks
  RECORDER          the bounded in-memory store of span records; read by
                    profile_trace's summary line (span_summary) and by
                    the benchmark
  STEP_LOG          how each training step ran while a profiler was
                    active: replayed from a CUDA graph of the step, or
                    eagerly and why (train/step_graph.py); read by the
                    benchmark
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from collections import defaultdict, deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from tf_repos_tpu_torch.utils.tb_events import TensorBoardWriter
from tf_repos_tpu_torch.utils.tree import tree_leaves


class MetricsWriter:
    """Append-only JSONL scalar events, {"step", "wall", "kind",
    <scalars>}, in model_dir/filename, and the same scalars as TensorBoard
    events in model_dir (tags "<kind>/<name>")."""

    def __init__(self, model_dir: str, filename: str = "metrics.jsonl", tensorboard: bool = True):
        os.makedirs(model_dir, exist_ok=True)
        self.path = os.path.join(model_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._tb = TensorBoardWriter(model_dir) if tensorboard else None

    def write(self, step: int, scalars: Dict[str, float], kind: str = "train") -> None:
        rec = {"step": int(step), "wall": time.time(), "kind": kind}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalars(step, {f"{kind}/{k}": float(v) for k, v in scalars.items()})

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class profile_trace:
    """Context manager: a torch.profiler trace into ``log_dir`` (the CUDA
    activity too when ``device`` is a card). The harness enters it at
    step profile_start_step and leaves it profile_steps steps later,
    after a device sync, so the window's kernels are in the trace."""

    def __init__(self, log_dir: str, device="cpu"):
        self.log_dir = log_dir
        self.device = torch.device(device)
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        os.makedirs(self.log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        worker = f"{socket.gethostname()}_{os.getpid()}"
        self._prof = profile(activities=acts,
                             on_trace_ready=tensorboard_trace_handler(self.log_dir, worker))
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._prof.__exit__(None, None, None)
            self._prof = None
            line = span_summary(RECORDER.records())
            if line:
                print("INFO: spans, " + line)
            RECORDER.clear()
        return False


# ------------------------------------------------------------------ spans
MAX_SPAN_RECORDS = 1 << 18


class _Record:
    __slots__ = ("name", "parent", "step", "count", "start_ns", "end_ns", "start_ev", "end_ev",
                 "own_end", "device_ms", "pooled")

    def __init__(self, name: str, parent: Optional[int], step: Optional[int], count: Any):
        self.name, self.parent, self.step, self.count = name, parent, step, count
        self.start_ns = self.end_ns = None
        self.start_ev = self.end_ev = None  # CUDA events until resolved
        self.own_end = True  # False once the next span took end_ev over as its start
        self.device_ms = None
        self.pooled = True  # False: the events are a step graph's, never the pool's

    def give_back(self, pool: List[Any]) -> None:
        if self.pooled:
            pool.append(self.start_ev)
            if self.own_end:
                pool.append(self.end_ev)


class SpanRecorder:
    """The span records of the process, in the order the spans opened, at
    most ``limit`` of them (``dropped`` counts the rest). A record's
    device extent is a pair of CUDA timing events on the current stream
    while CUDA is initialized in the process (else the host duration); a
    span that opens where the span before it closed takes that close's
    event over as its start, so one event marks the boundary. Events come
    from a pool: when a step span closes, the records of every earlier
    step the device has passed are resolved and their events go back to
    the pool, with no sync, so a profiled run builds events only in its
    first steps; ``records()`` synchronizes and resolves the rest."""

    def __init__(self, limit: int = MAX_SPAN_RECORDS):
        self.limit = limit
        self.dropped = 0
        self._recs: List[_Record] = []
        self._pool: List[Any] = []
        self._steps: deque = deque()  # indices of the step records not resolved yet
        self._cursor = 0  # the records before it were offered to _resolve
        self._lock = threading.Lock()
        self._step = 0
        self._halves: Dict[Any, "_BackwardHalf"] = {}

    def new_step(self) -> int:
        with self._lock:
            self._step += 1
            self._halves.clear()
            return self._step

    def _event(self):
        return self._pool.pop() if self._pool else torch.cuda.Event(enable_timing=True)

    def open(self, name: str, parent: Optional[int], step: Optional[int], count: Any,
             after: Optional[_Record] = None):
        """(index, record) of a new record started now; (None, None) past
        the limit. ``after``: the record that closed just before on this
        thread, with nothing launched since; its end event is this one's
        start."""
        rec = _Record(name, parent, step, count)
        fresh = False
        with self._lock:
            if len(self._recs) >= self.limit:
                self.dropped += 1
                return None, None
            self._recs.append(rec)
            index = len(self._recs) - 1
            if torch.cuda.is_initialized():
                if after is not None and after.end_ev is not None and after.own_end:
                    rec.start_ev, after.own_end = after.end_ev, False
                else:
                    rec.start_ev, fresh = self._event(), True
                rec.end_ev = self._event()
                if name == "step":
                    self._steps.append(index)
        rec.start_ns = time.time_ns()
        if fresh:
            rec.start_ev.record()
        return index, rec

    @staticmethod
    def close(rec: Optional[_Record]) -> None:
        if rec is None or rec.end_ns is not None:
            return
        if rec.end_ev is not None:
            rec.end_ev.record()
        rec.end_ns = time.time_ns()

    def _resolve(self, recs: List[_Record]) -> None:
        """Each closed record's device ms from its events, which go back to
        the pool, in order, up to the first the device has not reached
        (the events of one stream complete in the order they were
        recorded). Called with the lock held."""
        for r in recs:
            if r.end_ev is None or r.end_ns is None:
                continue
            try:
                r.device_ms = r.start_ev.elapsed_time(r.end_ev)
            except RuntimeError:  # not reached yet
                break
            r.give_back(self._pool)
            r.start_ev = r.end_ev = None

    def reclaim(self) -> None:
        """Resolve the records up to the end of each step tree whose step
        record's end the device has passed (an event query, no sync)."""
        with self._lock:
            while self._steps:
                rec = self._recs[self._steps[0]]
                if rec.end_ns is None or rec.end_ev is None or not rec.end_ev.query():
                    break
                j = self._steps.popleft() + 1
                while j < len(self._recs) and self._recs[j].step == rec.step:
                    j += 1
                self._resolve(self._recs[self._cursor:j])
                self._cursor = j

    def records(self) -> List[Dict[str, Any]]:
        """Every record as a dict: name, parent (index of the parent record
        or None), step (the enclosing step span's id or None), count,
        start_ns, end_ns (time.time_ns; end None while open), device_ms."""
        with self._lock:
            recs = list(self._recs)
        if any(r.end_ev is not None and r.end_ns is not None for r in recs):
            torch.cuda.synchronize()
        with self._lock:
            self._resolve(recs)
            self._steps.clear()
            self._cursor = len(self._recs)
        out = []
        for r in recs:
            ms = r.device_ms
            if ms is None and r.start_ev is None and r.end_ns is not None:
                ms = (r.end_ns - r.start_ns) * 1e-6
            out.append({"name": r.name, "parent": r.parent, "step": r.step, "count": r.count,
                        "start_ns": r.start_ns, "end_ns": r.end_ns, "device_ms": ms})
        return out

    def clear(self) -> None:
        """Drop every record (call it with no span open)."""
        with self._lock:
            for r in self._recs:
                if r.end_ev is not None:
                    r.give_back(self._pool)
            self._recs = []
            self._steps.clear()
            self._cursor = 0
            self._halves.clear()
            self.dropped = 0

    def half(self, name: str, step: Optional[int], count: Any, stack: List) -> "_BackwardHalf":
        """The backward half ``name`` of ``step``: one a step and name, so a
        region entered twice in a step (DIN's two lookups) has one."""
        if step is None:
            return _BackwardHalf(self, name, step, count, stack)
        with self._lock:
            h = self._halves.get((step, name))
            if h is None:
                h = self._halves[(step, name)] = _BackwardHalf(self, name, step, count, stack)
            return h

    def replayed(self, template: "SpanRecorder", start_ns: int, end_ns: int) -> Optional[_Record]:
        """A replay of a step graph whose capture recorded ``template``
        (span_template): a copy of its step tree under a new step id,
        with the graph's events, which the replay has just recorded again,
        and the replay's host times; the step record, or None past the
        limit. The tree's top takes the parent the thread's open spans
        give it now. The graph must not replay again before ``settle``
        has read these events."""
        recs = template._recs
        outer = _parent(_stack())
        with self._lock:
            if not recs or len(self._recs) + len(recs) > self.limit:
                self.dropped += len(recs)
                return None
            self._step += 1
            base = len(self._recs)
            for i, r in enumerate(recs):
                parent = outer if i == 0 else (None if r.parent is None else r.parent + base)
                c = _Record(r.name, parent, self._step, r.count)
                c.start_ns, c.end_ns = start_ns, end_ns
                c.start_ev, c.end_ev, c.own_end, c.pooled = r.start_ev, r.end_ev, r.own_end, False
                self._recs.append(c)
            if recs[0].end_ev is not None:
                self._steps.append(base)
            return self._recs[base]

    def settle(self, step_rec: Optional[_Record]) -> None:
        """Wait until the device has passed the end of ``step_rec`` (a
        replayed step's record) and resolve the records up to it: its
        graph is about to record the same events again."""
        if step_rec is not None and step_rec.end_ev is not None:
            step_rec.end_ev.synchronize()
            self.reclaim()


class _GraphTemplate(SpanRecorder):
    """The span records of one step while a CUDA graph of it is captured:
    each event is the graph's own (external: every replay records it),
    and nothing is resolved here, since no event may be queried while a
    stream captures."""

    def _event(self):
        return torch.cuda.Event(enable_timing=True, external=True)

    def reclaim(self) -> None:
        pass


RECORDER = SpanRecorder()
_local = threading.local()
_capture: List[Optional[SpanRecorder]] = [None]  # the template of the capture in progress


def _target() -> SpanRecorder:
    """Where spans record: the capture's template while a traced step
    graph is captured, else RECORDER."""
    return _capture[0] or RECORDER


@contextmanager
def span_template() -> Iterator[SpanRecorder]:
    """While a step graph is captured under a profiler: the spans opened
    inside record into the template yielded (train/step_graph.py hands
    it to RECORDER.replayed after each replay)."""
    template = _capture[0] = _GraphTemplate()
    try:
        yield template
    finally:
        _capture[0] = None
        _local.closed = None


def _stack() -> List:
    """This thread's open spans, (index, record) each ((None, None) for
    one past the recorder's limit)."""
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
        _local.step = None
        _local.closed = None  # the record this thread closed last, if none opened since
    return s


def _parent(stack: List) -> Optional[int]:
    return stack[-1][0] if stack else None


class _BackwardHalf:
    """``<name>.bwd``: opened by the first gradient of the region's
    outputs to arrive, closed once the gradients of its inputs are
    computed. The hooks run on the autograd thread and record there, on
    the stream the engine makes current (the forward's); the parent is
    the span open on the forward's thread (the step's backward).

    A tensor's gradient hook runs when the engine runs the node that
    made the tensor, and the engine runs the ready node made last first:
    a region's nodes, all made after its inputs, run before any input's
    node. So the half closes at the first input node the engine runs
    (register_multi_grad_hook, mode "any"): waiting for all of them
    would take in what runs between, such as DIN's slot lookup behind
    the attention. The region's weights get their gradients in its own
    nodes, so their hooks are left out where the region has an input
    made by a node. A region whose inputs are all leaves waits for each
    leaf's hook, which runs once its summed gradient is captured
    (register_multi_grad_hook refuses leaves under torch.autograd.grad,
    the step's call)."""

    def __init__(self, rec: SpanRecorder, name: str, step, count, stack: List):
        self.recorder, self.name, self.step, self.count, self.stack = rec, name, step, count, stack
        self.pending = 0
        self.rec = None
        self.opened = False

    def open(self, *_):
        if not self.opened:
            self.opened = True
            self.rec = self.recorder.open(self.name, _parent(self.stack), self.step, self.count)[1]

    def done(self, *_):
        self.pending -= 1
        if self.pending == 0 and self.opened:
            self.recorder.close(self.rec)

    def watch(self, outputs: List[torch.Tensor], inputs: List[torch.Tensor]) -> None:
        # a pre-hook of the output's node: it runs after the node's tensor
        # hooks, so a half that closes at the same node (the region before,
        # whose input this output is) closes first
        for t in outputs:
            if t.grad_fn is not None:
                t.grad_fn.register_prehook(self.open)
            else:
                t.register_hook(self.open)
        inner = [t for t in inputs if t.grad_fn is not None]
        if inner:
            self.pending += 1
            torch.autograd.graph.register_multi_grad_hook(inner, self.done, mode="any")
            return
        self.pending += len(inputs)
        for t in inputs:
            t.register_hook(self.done)


class _Span:
    __slots__ = ("name", "count", "adjacent", "rec", "rf", "step", "saved_step", "stack")

    def __init__(self, name: str, count: Optional[Callable[[], Any]], adjacent: bool):
        self.name, self.count, self.adjacent = name, count, adjacent

    def __enter__(self):
        stack = self.stack = _stack()
        self.saved_step = _local.step
        if self.name == "step":
            _local.step = _target().new_step()
        self.step = _local.step
        if self.count is not None:
            self.count = self.count()
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        after, _local.closed = (_local.closed if self.adjacent else None), None
        index, self.rec = _target().open(self.name, _parent(stack), self.step, self.count, after)
        stack.append((index, self.rec))
        return self

    def __exit__(self, *exc):
        self.stack.pop()
        _target().close(self.rec)
        _local.closed = self.rec
        self.rf.__exit__(*exc)
        if self.name == "step":
            _target().reclaim()
        _local.step = self.saved_step
        return False

    def backward_half(self, outputs, inputs) -> None:
        """Record ``<name>.bwd``: from the first gradient of ``outputs`` to
        arrive until the gradients of ``inputs`` (trees of tensors; those
        that require grad) are computed, as _BackwardHalf says."""
        outs = [t for t in tree_leaves(outputs) if isinstance(t, torch.Tensor) and t.requires_grad]
        ins = [t for t in tree_leaves(inputs) if isinstance(t, torch.Tensor) and t.requires_grad]
        if outs and ins:
            _target().half(self.name + ".bwd", self.step, self.count, self.stack).watch(outs, ins)


class _Off:
    """The span while no profiler runs: nothing recorded, no hook."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def backward_half(self, outputs, inputs) -> None:
        pass


_OFF = _Off()


def span(name: str, count: Optional[Callable[[], Any]] = None, adjacent: bool = False):
    """``with span(name[, count][, adjacent]) as s:`` a region of the step
    or the model; after it, ``s.backward_half(outputs, inputs)`` records
    its backward half. A span named "step" starts a new step id, which
    the spans inside it and their backward halves carry. ``count`` gives
    the region's work (a number, or a dict of them) from shapes the host
    knows; it is called only while a profiler runs. ``adjacent``: the
    span opens where the one before it on this thread closed, with
    nothing launched between, so the two share that boundary's event.
    With no profiler active both are one shared no-op (the flag
    torch.profiler's start sets, whatever activities it traces)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, count, adjacent)


class StepLog:
    """How each training step ran while a profiler was active, in order:
    "graph" (replayed from a CUDA graph of the step, captured just before
    or earlier) or "eager: <reason>" (train/step_graph.py); at most
    ``limit`` entries, as RECORDER. ``take`` returns them and empties
    the log."""

    def __init__(self, limit: int = MAX_SPAN_RECORDS):
        self.limit = limit
        self._entries: List[str] = []

    def note(self, how: str) -> None:
        if _autograd_profiler._is_profiler_enabled and len(self._entries) < self.limit:
            self._entries.append(how)

    def take(self) -> List[str]:
        out, self._entries = self._entries, []
        return out


STEP_LOG = StepLog()


def step_trees(records: List[Dict[str, Any]],
               steps: Optional[int] = None) -> List[Dict[str, Any]]:
    """The records of the first ``steps`` step trees (every one by
    default): each "step" record and every record that carries its step
    id (the spans inside it and its backward halves)."""
    ids = [r["step"] for r in records if r["name"] == "step"]
    ids = set(ids if steps is None else ids[:steps])
    return [r for r in records if r["step"] in ids]


def span_ms_per_step(records: List[Dict[str, Any]],
                     steps: Optional[int] = None) -> Dict[str, float]:
    """Each span name's device ms a step over the first ``steps`` step
    trees of ``records`` (every one by default); records still open are
    left out."""
    recs = step_trees(records, steps)
    n = sum(r["name"] == "step" for r in recs)
    total: Dict[str, float] = defaultdict(float)
    for r in recs:
        if r["device_ms"] is not None:
            total[r["name"]] += r["device_ms"]
    return {k: v / n for k, v in total.items()} if n else {}


def _total(count) -> float:
    return sum(count.values()) if isinstance(count, dict) else count


def span_summary(records: List[Dict[str, Any]]) -> str:
    """profile_trace's line: each span of the step trees by its device ms
    a step and, where it carries a count (the step's rows, the update's
    rows, the attention's slots), by the count over its device ms; each
    span outside them with no parent (input.wait) by its host ms a call.
    Empty where there is nothing to say."""
    trees = step_trees(records)
    ms = span_ms_per_step(trees)
    counted: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0.0])
    for r in trees:
        if r["count"] is not None and r["device_ms"]:
            counted[r["name"]][0] += _total(r["count"])
            counted[r["name"]][1] += r["device_ms"]
    host: Dict[str, List[float]] = defaultdict(list)
    for r in records:
        if r["step"] is None and r["parent"] is None and r["end_ns"] is not None:
            host[r["name"]].append((r["end_ns"] - r["start_ns"]) * 1e-6)
    parts = []
    if ms:
        steps = sum(r["name"] == "step" for r in trees)
        parts.append(f"device ms a step [count a device ms] over {steps} steps: " + ", ".join(
            f"{k} {v:.4f}" + (f" [{counted[k][0] / counted[k][1]:.1f}]" if k in counted else "")
            for k, v in sorted(ms.items())))
    if host:
        parts.append("host ms a call outside the steps: " + ", ".join(
            f"{k} {sum(v) / len(v):.4f} (x{len(v)})" for k, v in sorted(host.items())))
    return "; ".join(parts)


def _has_nan(tensors) -> bool:
    flags = [torch.isnan(t).any() for t in tensors
             if isinstance(t, torch.Tensor) and t.is_floating_point()]
    return bool(torch.stack(flags).any()) if flags else False


def enable_nan_checks(step: Callable) -> Callable:
    """Wrap a harness train step, (state, batch, generator, sr_generator)
    -> (state, loss), so that after every step it checks the loss, every
    updated parameter (the table shards on a mesh rank) and the model
    state for NaN, with one device sync, and raises FloatingPointError
    naming the first NaN leaf. As with jax_debug_nans, infinities pass."""

    def checked(state, batch, generator=None, sr_generator=None):
        state, loss = step(state, batch, generator, sr_generator)
        leaves = [loss] + tree_leaves(state["params"]) + tree_leaves(state["mstate"])
        if _has_nan(leaves):
            what = "loss" if _has_nan([loss]) else "an updated parameter or the model state"
            raise FloatingPointError(f"--check_numerics: the train step produced a NaN in {what}")
        return state, loss

    return checked
