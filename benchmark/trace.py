"""The traced window: torch.profiler (CPU and CUDA activity) over a run
of steps that ends in a synchronize, reduced to what the per-layer
readers read. The benchmark's own spans: the window itself, and the
arguments of each kernel entry a reader names (recorded at the Python
call, from the shapes, with no device sync)."""

from __future__ import annotations

import bisect
import functools
import importlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

@dataclass
class Trace:
    window_s: float  # the traced window, by the profiler's clock
    steps: int
    model_flops: float  # the reference's count for the window's steps
    device_ops: List[Tuple[str, float, float]]  # (name, start s, end s), kernels, copies, fills
    host_ops: List[Tuple[str, float, float]]  # host operations of the stepping thread
    calls: Dict[Tuple[str, str], List] = field(default_factory=dict)

    def busy(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the window."""
        out: List[List[float]] = []
        for _, a, b in sorted(self.device_ops, key=lambda e: e[1]):
            a, b = max(a, 0.0), min(b, self.window_s)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_seconds(self, symbols) -> Tuple[float, int]:
        """(device seconds, launches) of the device operations whose name
        holds one of ``symbols``."""
        hits = [b - a for name, a, b in self.device_ops if any(s in name for s in symbols)]
        return sum(hits), len(hits)

    def top_device_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, float] = defaultdict(float)
        for name, a, b in self.device_ops:
            total[name] += b - a
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[List]:
        """The device's idle time in the window by what the stepping thread
        was doing at each gap's middle (its innermost host operation)."""
        ops = sorted(self.host_ops, key=lambda e: e[1])
        starts = [a for _, a, _ in ops]
        gaps, edge = [], 0.0
        for a, b in self.busy() + [(self.window_s, self.window_s)]:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        total: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid, name = (a + b) / 2, "no host operation"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 256, -1), -1):
                if ops[j][2] >= mid:
                    name = ops[j][0]
                    break
            total[name[:160]] += b - a
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


class CallRecorder:
    """Wraps named Python entries of the port (module, attribute) so that
    each call appends ``summarize(*args, **kwargs)`` to ``calls``; the
    originals are put back on exit. Attributes of the function (a launch
    counter) are carried over to the wrapper."""

    def __init__(self, entries: Dict[Tuple[str, str], Callable]):
        self.entries = entries
        self.calls: Dict[Tuple[str, str], List] = {k: [] for k in entries}
        self._saved = []

    def __enter__(self):
        for (mod_name, attr), summarize in self.entries.items():
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, attr)
            log = self.calls[(mod_name, attr)]

            @functools.wraps(orig)
            def wrapper(*a, _orig=orig, _log=log, _sum=summarize, **k):
                _log.append(_sum(*a, **k))
                return _orig(*a, **k)

            self._saved.append((mod, attr, orig))
            setattr(mod, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()


def traced_window(step: Callable[[int], object], seconds: float, flops_per_step: Callable[[int], float],
                  entries, device, host: bool = True) -> Trace:
    """Steps ``step(i)`` for ``seconds`` of host time under the profiler,
    then synchronizes; the window runs from the first step's call to the
    synchronize's return. ``host`` traces the host's operations too (the
    idle gaps' attribution), at a cost in host time; on the CPU (the
    tests) only host activity is traced."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = ([ProfilerActivity.CPU] if host or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    recorder = CallRecorder(entries)
    with recorder, profile(activities=activities) as prof:
        # the profiler's events carry the system clock's nanoseconds
        t0, w0, n = time.perf_counter(), time.time_ns(), 0
        while time.perf_counter() - t0 < seconds:
            step(n)
            n += 1
        if cuda:
            torch.cuda.synchronize(device)
        w1 = time.time_ns()
    events = prof.profiler.kineto_results.events()
    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    # the stepping thread: the one with the most host operations
    count: Dict[int, int] = defaultdict(int)
    for e in events:
        if e.device_type() == cpu:
            count[e.start_thread_id()] += 1
    main = max(count, key=count.get) if count else None
    device_ops, host_ops = [], []
    for e in events:
        name = e.name()
        a, b = (e.start_ns() - w0) * 1e-9, (e.end_ns() - w0) * 1e-9
        if e.device_type() == dev:
            if "Sync" in name or b <= a:
                continue
            device_ops.append((name, a, b))
        elif e.device_type() == cpu and e.start_thread_id() == main and b > a:
            host_ops.append((name, a, b))
    flops = sum(flops_per_step(i) for i in range(n))
    return Trace(window_s=(w1 - w0) * 1e-9, steps=n, model_flops=flops,
                 device_ops=device_ops, host_ops=host_ops, calls=recorder.calls)
