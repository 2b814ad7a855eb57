"""The lazy-sparse training step replayed from CUDA graphs
(build_sparse_train_step returns its step wrapped in GraphedStep).

A step's Python launches some two hundred kernels, each with its autograd
node and its host time; where the host is slower than the card, the card
waits. GraphedStep captures the whole step (the row gather, the forward,
autograd.grad, the dense update and the row update, every hand-written
kernel among them) once for each batch signature, the names, shapes and
dtypes of the batch's tensors, and from then on replays it: one launch a
step. A step object's graphs share one memory pool.

When it engages: every batch tensor is on a card, and no generator is
passed, neither the dropout's nor the rounding's, so nothing draws random
numbers; the row optimizer has no per-row catch-up (its step count enters
the rows on the host). The step object's first call runs eagerly, and so
does every call after the parameters or the optimizer state were swapped
for other tensors, or a count in the state was changed from outside.

Capture: the batch is copied into static buffers made for its signature;
the step's Python runs once on a side stream while the graph records what
it launches, and nothing executes. Then the graph replays: that is the
call's step. A later call with the signature copies its batch into the
buffers (one copy a dtype) and replays. Each call returns a loss of its
own, copied from the graph's output.

What the step's Python does on the host, each replay does too: the
integer counts in the optimizer state (Adam's step counts) advance as
the capture advanced them, and so do the kernel entries' launch counters.
A count that feeds device work is advanced on the device
(train/optimizers.BiasCorrections), so a replay uses its own. A capture
that raises leaves its signature eager, and says why once.

Under a profiler the first calls of each signature capture traced
variants (TRACED_COPIES of them, replayed in turn): their spans record
into a template with events inside the graph
(utils/observability.span_template), and after each replay the span
recorder gets a whole step tree. A copy waits, before it replays again,
until the device has passed its last replay, whose events the recorder
then reads; with copies in turn that wait costs the card nothing. Each
call notes how it ran in observability.STEP_LOG while a profiler runs.

Memory: the graphs of a signature share its static buffers, made in
segments of their own (the allocator's cache is released first). Each
capture runs under torch.cuda.graph, which releases the cache too, with
cuBLAS's workspaces cleared before and after it (as torch's graph trees
do): the eager steps' workspace would stay reserved beside the graphs'
pool, and the capture's own is the pool's."""

from __future__ import annotations

import contextlib
import importlib
import numbers
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

from tf_repos_tpu_torch.utils import observability as O
from tf_repos_tpu_torch.utils.tree import tree_leaves

# the op modules whose kernel entries count their launches in ``launches``
OP_MODULES = ("sparse_rows", "coo_pool", "sorted_seg", "row_scatter", "field_block", "att_unit")
TRACED_COPIES = 3


def signature(batch: Dict[str, Any]) -> Optional[Tuple]:
    """(name, shape, dtype, device index) of each batch tensor, or None
    where a value is not a tensor on a card."""
    sig = []
    for k, v in batch.items():
        if not isinstance(v, torch.Tensor) or not v.is_cuda:
            return None
        sig.append((k, tuple(v.shape), v.dtype, v.get_device()))
    return tuple(sig)


def _scan(tree, ptrs: List[int], ints: List[Tuple[Any, Any]]) -> None:
    """The data pointers of the tensors in ``tree`` and the (container,
    key) of its integers, in tree order."""
    if isinstance(tree, torch.Tensor):
        ptrs.append(tree.data_ptr())
        return
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return
    for k, v in items:
        if isinstance(v, numbers.Integral) and not isinstance(v, bool):
            ints.append((tree, k))
        else:
            _scan(v, ptrs, ints)


def launch_counters() -> List[Tuple[Any, str]]:
    """(module, name) of each kernel entry with a launch counter, in the
    module that defines it (another's import of it is the same counter)."""
    out = []
    for name in OP_MODULES:
        mod = importlib.import_module("tf_repos_tpu_torch.ops." + name)
        out += [(mod, n) for n, f in vars(mod).items()
                if callable(f) and hasattr(f, "launches") and f.__module__ == mod.__name__]
    return out


def _copy_batch(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]) -> None:
    """dst[k] <- src[k] for every key: one foreach copy a dtype."""
    groups: Dict[torch.dtype, Tuple[List, List]] = {}
    for k, v in src.items():
        d, s = groups.setdefault(v.dtype, ([], []))
        d.append(dst[k])
        s.append(v)
    for d, s in groups.values():
        torch._foreach_copy_(d, s)


class CudaGraph:
    """One step's CUDA graph, captured into the step object's memory pool."""

    def __init__(self, pool):
        self.graph, self.pool = torch.cuda.CUDAGraph(), pool

    def capture(self, fn: Callable[[], Any]) -> Any:
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool):
                return fn()
        finally:
            torch._C._cuda_clearCublasWorkspaces()

    def replay(self) -> None:
        self.graph.replay()

    @staticmethod
    def new_pool():
        return torch.cuda.graph_pool_handle()


class _Entry:
    """A captured signature: its graph, static batch and loss, what each
    replay adds to the host's counts, and its span template."""

    __slots__ = ("graph", "batch", "loss", "mstate", "ints", "launches", "template", "last")

    def __init__(self, graph, batch, loss, mstate, ints, launches, template):
        self.graph, self.batch, self.loss, self.mstate = graph, batch, loss, mstate
        self.ints, self.launches, self.template = ints, launches, template
        self.last = None  # the step record of the traced variant's last replay


class GraphedStep:
    """The step (params, opt_state, mstate, batch, generator=None,
    sr_generator=None) -> (params, opt_state, mstate, loss), replayed
    from a CUDA graph where it can be (the module's docstring says when).
    ``eager_only``: why this step never takes a graph (None: it may).
    ``counts``: how many calls replayed a graph captured earlier, captured
    and replayed one, and ran eagerly."""

    Graph = CudaGraph  # the class that captures and replays (tests stand a stub in)

    def __init__(self, step: Callable, eager_only: Optional[str] = None):
        self._step = step
        self.eager_only = eager_only
        self.counts = {"replay": 0, "capture": 0, "eager": 0}
        # (signature, None) or, traced, (signature, copy) -> _Entry, or why its capture failed
        self._graphs: Dict[Tuple, Any] = {}
        self._buffers: Dict[Tuple, Dict[str, torch.Tensor]] = {}  # a signature's static batch
        self._turn: Dict[Tuple, int] = {}  # a signature's next traced copy
        self._ptrs: Optional[List[int]] = None  # the state the graphs were captured on
        self._vals: Optional[List[int]] = None  # its counts after the last call
        self._pool = None
        self._told = set()
        self._counters = None

    # ------------------------------------------------------------ dispatch
    def __call__(self, params, opt_state, mstate, batch, generator=None, sr_generator=None):
        why = self.eager_only
        if why is None:
            if generator is not None:
                why = "generator"
            elif sr_generator is not None:
                why = "sr_generator"
        sig = signature(batch) if why is None else None
        if why is None and sig is None:
            why = "cpu tensors"
        if why is not None:
            self._vals = None
            return self._eager(why, params, opt_state, mstate, batch, generator, sr_generator)
        ptrs, ints = [], []
        _scan((params, opt_state, mstate), ptrs, ints)
        # the dicts that hold counts too: their device copies are keyed by
        # the dict (train/optimizers.BiasCorrections)
        ptrs += [id(c) for c, _ in ints]
        vals = [c[k] for c, k in ints]
        entry = None
        if ptrs != self._ptrs:
            why = "first call" if self._ptrs is None else "new state"
            self._drop()
            self._ptrs = ptrs
        elif vals != self._vals:
            why = "counts changed"
        else:
            key = (sig, self._next_copy(sig))
            entry = self._graphs.get(key)
            if isinstance(entry, str):
                why = entry
            elif entry is None:
                entry, why = self._capture(key, params, opt_state, mstate, batch, ints)
            else:
                _copy_batch(entry.batch, batch)
                for c, k, d in entry.ints:
                    c[k] += d
                for m, n, d in entry.launches:
                    getattr(m, n).launches += d
                self.counts["replay"] += 1
        if why is not None:
            out = self._eager(why, params, opt_state, mstate, batch, None, None)
        else:
            out = self._replay(entry, params, opt_state)
        self._vals = [c[k] for c, k in ints]
        return out

    def _next_copy(self, sig) -> Optional[int]:
        """None untraced; under a profiler, the signature's traced copy
        whose turn it is."""
        if not _autograd_profiler._is_profiler_enabled:
            return None
        copy = self._turn.get(sig, 0)
        self._turn[sig] = (copy + 1) % TRACED_COPIES
        return copy

    def _drop(self) -> None:
        self._graphs.clear()
        self._buffers.clear()
        self._turn.clear()

    def _eager(self, why, *args):
        self.counts["eager"] += 1
        O.STEP_LOG.note("eager: " + why)
        return self._step(*args)

    # ------------------------------------------------------------- capture
    def _launch_counts(self) -> List[int]:
        if self._counters is None:
            self._counters = launch_counters()
        return [getattr(m, n).launches for m, n in self._counters]

    def _capture(self, key, params, opt_state, mstate, batch, ints):
        """(entry, None) once the step is captured, to be replayed as this
        call's step; (None, why) where this call must run eagerly (a failed
        capture also marks its key). key: (signature, traced copy or None);
        ints: where the state's integers are (_scan)."""
        static = self._buffers.get(key[0])
        if static is None:
            if torch.cuda.is_available():
                # the buffers outlive the eager steps: in a cached segment of
                # theirs they would keep all of it reserved. cuBLAS's
                # workspace lives in such a segment: clear it first, or the
                # release keeps that segment and the buffers land in it
                torch._C._cuda_clearCublasWorkspaces()
                torch.cuda.empty_cache()
            static = self._buffers[key[0]] = {
                k: torch.empty_like(v, memory_format=torch.contiguous_format)
                for k, v in batch.items()}
        _copy_batch(static, batch)
        before = [c[k] for c, k in ints]
        launches = self._launch_counts()
        if self._pool is None:
            self._pool = self.Graph.new_pool()
        graph = self.Graph(self._pool)
        try:
            with O.span_template() if key[1] is not None else contextlib.nullcontext() as template:
                out = graph.capture(lambda: self._step(params, opt_state, mstate, static))
            _, _, new_mstate, loss = out
            if [id(t) for t in tree_leaves(new_mstate)] != [id(t) for t in tree_leaves(mstate)]:
                raise RuntimeError("the step returns a model state of new tensors")
        except Exception as e:  # noqa: BLE001 -- any failure leaves the signature eager
            self._undo(ints, before, launches)
            why = f"capture failed: {type(e).__name__}: {e}"
            self._graphs[key] = "capture failed"
            if type(e) not in self._told:
                self._told.add(type(e))
                print(f"WARNING: the training step runs eagerly for a batch signature: {why}",
                      flush=True)
            return None, "capture failed"
        deltas = [(c, k, c[k] - b) for (c, k), b in zip(ints, before) if c[k] != b]
        added = [(m, n, a - b) for (m, n), a, b in zip(self._counters, self._launch_counts(),
                                                      launches) if a != b]
        entry = self._graphs[key] = _Entry(graph, static, loss, new_mstate, deltas, added, template)
        self.counts["capture"] += 1
        return entry, None

    def _undo(self, ints, before, launches) -> None:
        """Put back the counts a capture that failed had advanced."""
        for (c, k), b in zip(ints, before):
            c[k] = b
        for (m, n), b in zip(self._counters, launches):
            getattr(m, n).launches = b

    # -------------------------------------------------------------- replay
    def _replay(self, entry: _Entry, params, opt_state):
        """The step: a replay of ``entry``'s graph on its static batch."""
        O.STEP_LOG.note("graph")
        if entry.template is not None:
            O.RECORDER.settle(entry.last)
            start = time.time_ns()
            entry.graph.replay()
            entry.last = O.RECORDER.replayed(entry.template, start, time.time_ns())
            O.RECORDER.reclaim()
        else:
            entry.graph.replay()
        return params, opt_state, entry.mstate, entry.loss.clone()
