"""Reading a ``torch.profiler`` trace of the card into busy time, host tails
and labelled idle gaps.

The busy-union and host-tail arithmetic is a frozen copy of
``chip_smoke.py::read_trace`` (at commit a5f2a9c): the device's busy time
is the union of its kernels' and copies' intervals, and a read's host tail
is the time after the last device op it launched.  Idle gaps are labelled
by the innermost harness span (``record_function`` named ``mvb:<what>``)
open at the gap's middle.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "mvb:"


def span(name: str):
    """A harness span: a ``record_function`` range that the trace keeps
    (free when no profiler runs)."""
    return torch.profiler.record_function(PREFIX + name)


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Capture:
    """Profiles the card between ``start()`` and ``stop()`` (or over a
    ``with``); ``summary()`` reduces the trace once the capture ended."""

    def __init__(self):
        self.prof = None
        self._span = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._span = span("window")
        self._span.__enter__()

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    @staticmethod
    def warm_up() -> None:
        """Start and stop the profiler once, so that its first start (which
        initialises the tracer) falls in set-up and not in the window."""
        cap = Capture()
        cap.start()
        torch.zeros(1, device="cuda" if torch.cuda.is_available()
                    else "cpu").add_(1)
        cap.stop()

    def __enter__(self) -> "Capture":
        self.start()
        return self

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def summary(self, kernel_groups: Optional[Dict[str, Tuple[str, ...]]]
                = None, tail_prefix: str = "read:") -> dict:
        """``busy_s``, ``window_s``, top device ops, idle seconds by span
        label, the host tail of each span named ``tail_prefix...``, and
        the device seconds of each kernel group (a group is the kernels
        whose name holds one of its words)."""
        dev, spans = [], []
        for e in self.prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.name.startswith(PREFIX):
                # the tracer mirrors each span on the device's timeline as
                # an annotation: a span, not an op that ran there
                if e.device_type != torch.autograd.DeviceType.CUDA:
                    spans.append((a, b, e.name[len(PREFIX):]))
            elif e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((a, b, e.name))
        win = [s for s in spans if s[2] == "window"]
        if not win:
            raise RuntimeError("the trace lost the window span")
        w0, w1 = win[0][0], win[0][1]
        dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if b > w0 and a < w1]
        busy = union([(a, b) for a, b, _ in dev])
        busy_us = sum(b - a for a, b in busy)
        by_name: Dict[str, float] = {}
        for a, b, n in dev:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        inner = sorted((s for s in spans if s[2] != "window"),
                       key=lambda s: (s[0], -s[1]))
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        idle: Dict[str, float] = {}
        stack: list = []
        i = 0
        for a, b in gaps:            # in time order; harness spans nest
            mid = 0.5 * (a + b)
            while i < len(inner) and inner[i][0] <= mid:
                while stack and stack[-1][1] < inner[i][0]:
                    stack.pop()
                stack.append(inner[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            label = stack[-1][2] if stack else "harness"
            idle[label] = idle.get(label, 0.0) + (b - a)
        starts = sorted((a, b) for a, b, _ in dev)
        keys = [a for a, _ in starts]
        tails = []
        for a, b, n in inner:
            if not n.startswith(tail_prefix):
                continue
            lo, hi = bisect.bisect_left(keys, a), bisect.bisect_right(keys, b)
            if hi > lo:
                last = max(y for _, y in starts[lo:hi])
                tails.append((n, (b - a) / 1e6, max(0.0, b - last) / 1e6))
        groups = {}
        for g, words in (kernel_groups or {}).items():
            groups[g] = sum(t for n, t in by_name.items()
                            if any(w in n for w in words)) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
                "device_ops": [[n, t / 1e6] for n, t in top],
                "idle_gaps": [[n, t / 1e6] for n, t in gaps],
                "span_tails": tails, "kernel_s": groups}
