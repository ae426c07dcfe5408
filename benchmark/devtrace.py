"""What a ``torch.profiler`` trace of a few calls says about the device.

Ranges: the benchmark opens ``torch.profiler.record_function`` ranges from
its own files: one around each traced call (``call``), and, from
a forward pre-hook and a forward hook it hangs on the model's ``encoder`` and
``decoder`` children, one around each of those.  A device operation belongs
to the innermost range that was open on the host when it was launched (its
runtime call's start time lies inside the range on the same thread).

From the trace: each device operation (kernel, copy, set) with its name,
start, length and range; the busy time (the union of the operations'
intervals); idle gaps between consecutive operations, each labelled with the
range the host was in and the host operation that launched the operation
after the gap.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Tuple

import torch

PREFIX = "bench."


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    dur_ns: int
    range: str  # innermost benchmark range at launch, or "" outside every one
    launcher: str  # the host operation that launched it


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    window_s: float  # host clock over the traced calls, synchronised
    calls: int

    @property
    def busy_s(self) -> float:
        spans = sorted((o.start_ns, o.start_ns + o.dur_ns) for o in self.ops)
        busy, end = 0, None
        for s, e in spans:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy / 1e9

    def device_s_in(self, rng: str) -> float:
        return sum(o.dur_ns for o in self.ops if o.range == rng) / 1e9

    def top_ops(self, k: int = 10) -> List[Tuple[str, float]]:
        by = Counter()
        for o in self.ops:
            by[o.name] += o.dur_ns / 1e9
        return [[n[:200], s] for n, s in by.most_common(k)]

    def idle_gaps(self, k: int = 10) -> List[Tuple[str, float]]:
        """The idle time between consecutive device operations, summed by
        what the host was doing (range / launching operation), largest
        first."""
        ops = sorted(self.ops, key=lambda o: o.start_ns)
        by = Counter()
        end = None
        for o in ops:
            if end is not None and o.start_ns > end:
                by[f"{o.range or 'outside ranges'}/{o.launcher}"[:200]] += (o.start_ns - end) / 1e9
            end = o.start_ns + o.dur_ns if end is None else max(end, o.start_ns + o.dur_ns)
        return [[n, s] for n, s in by.most_common(k)]


class Ranges:
    """``record_function`` ranges on a module's children, opened by a forward
    pre-hook and closed by a forward hook, each named ``bench.<child>``."""

    def __init__(self, model: torch.nn.Module, children=("encoder", "decoder")):
        self.handles, self.open = [], {}
        for name in children:
            mod = getattr(model, name)
            self.handles.append(mod.register_forward_pre_hook(self._enter(name)))
            self.handles.append(mod.register_forward_hook(self._exit(name)))

    def _enter(self, name):
        def hook(module, args):
            rf = torch.profiler.record_function(PREFIX + name)
            rf.__enter__()
            self.open[name] = rf
        return hook

    def _exit(self, name):
        def hook(module, args, output):
            rf = self.open.pop(name, None)
            if rf is not None:
                rf.__exit__(None, None, None)
        return hook

    def remove(self):
        for h in self.handles:
            h.remove()


def call_range():
    return torch.profiler.record_function(PREFIX + "call")


def _is_device(ev) -> bool:
    return ev.device_type() != torch.autograd.DeviceType.CPU


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu")) and not name.startswith(PREFIX)


def _innermost(host, points):
    """For each (thread, time, key) of ``points``, the innermost benchmark
    range and the innermost host operator open on that thread at that time:
    {key: (range, operator)}.  Host intervals nest on a thread, so one sweep
    with a stack per kind does.  A launch from a thread that opened no range
    (autograd's backward runs on a device thread of its own) is labelled
    ``autograd thread``; one outside every operator (the port's kernels are
    launched through ctypes from Python) ``python``."""
    by_thread: Dict[int, list] = {}
    for e in host:
        name = e.name()
        if _is_runtime(name):
            continue
        kind = "range" if name.startswith(PREFIX) else "op"
        label = name[len(PREFIX):] if kind == "range" else name
        spans = by_thread.setdefault(e.start_thread_id(), [])
        spans.append((e.start_ns(), e.end_ns(), kind, label))
    out = {}
    ranged = {tid for tid, spans in by_thread.items()
              if any(sp[2] == "range" for sp in spans)}
    pts_by_thread: Dict[int, list] = {}
    for tid, t, key in points:
        pts_by_thread.setdefault(tid, []).append((t, key))
    for tid, pts in pts_by_thread.items():
        spans = sorted(by_thread.get(tid, []), key=lambda sp: (sp[0], -sp[1]))  # outer first
        stacks = {"range": [], "op": []}
        i = 0
        for t, key in sorted(pts):
            while i < len(spans) and spans[i][0] <= t:
                stacks[spans[i][2]].append(spans[i])
                i += 1
            for st in stacks.values():
                while st and st[-1][1] < t:
                    st.pop()
            rng = next((sp[3] for sp in reversed(stacks["range"]) if sp[1] >= t),
                       "" if tid in ranged else "autograd thread")
            op = next((sp[3] for sp in reversed(stacks["op"]) if sp[1] >= t), "python")
            out[key] = (rng, op)
    return out


def read(prof, window_s: float, calls: int) -> Trace:
    """The device operations of a finished ``torch.profiler.profile``."""
    events = list(prof.profiler.kineto_results.events())
    host = [e for e in events if not _is_device(e)]
    launches = {e.correlation_id(): e for e in host if _is_runtime(e.name())}
    device = [e for e in events if _is_device(e) and not e.is_user_annotation()]
    points = []
    for j, e in enumerate(device):
        launch = launches.get(e.linked_correlation_id()) or launches.get(e.correlation_id())
        if launch is not None:
            points.append((launch.start_thread_id(), launch.start_ns(), j))
    where = _innermost(host, points)
    ops = [DeviceOp(e.name(), e.start_ns(), e.duration_ns(), *where.get(j, ("", "unknown")))
           for j, e in enumerate(device)]
    return Trace(ops, window_s, calls)


def profile():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)
