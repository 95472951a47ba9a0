"""Reading a ``torch.profiler`` trace of the measured window: device busy
time, device time by kernel and by span, and what the host was doing
while the device sat idle.

``moe_spans`` and the category rule of :func:`span_device_ms` are copied
from ``repro_torch/launch/profile.py`` (``moe_spans``, ``breakdown``),
so a change there cannot move this yardstick: within the block each MoE
helper of the port runs under a ``record_function`` range of its
category, set from outside (the model code carries no hooks), and a
range's device time is that of the kernels its ops launched.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch

#: the MoE helpers timed under a profiler range each, by category
MOE_SPANS = {"_experts": "moe.expert_products",
             "_shared": "moe.shared_experts",
             "_route": "moe.routing_glue", "_slots": "moe.routing_glue",
             "_dispatch": "moe.routing_glue", "_combine": "moe.routing_glue"}
K1_SYMBOL, K2_SYMBOL = "flash_fwd", "decode_fwd"
HOST_LABELS = ("decode_all", "prefill_batch", "controller_update", "submit")


@contextlib.contextmanager
def moe_spans():
    from repro_torch.models import moe
    saved = {name: getattr(moe, name) for name in MOE_SPANS}

    def spanned(fn, label):
        def run(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)
        return run

    for name, fn in saved.items():
        setattr(moe, name, spanned(fn, MOE_SPANS[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(moe, name, fn)


def _is_range(name: str) -> bool:
    return name.startswith("bench.") or name in MOE_SPANS.values()


class Trace:
    """The parts of one profiler window the readers use (times in
    seconds)."""

    def __init__(self, prof, window_s: float):
        self.window_s = window_s
        dev: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.range_device_us: Dict[str, float] = {}
        self.decode_ranges = 0
        events = prof.events()
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not _is_range(e.name):
                    dev.append((e.name, e.time_range.start / 1e6,
                                e.time_range.end / 1e6))
            elif e.name.startswith("bench."):
                self.host.append((e.name[len("bench."):],
                                  e.time_range.start / 1e6,
                                  e.time_range.end / 1e6))
                if e.name == "bench.decode_all":
                    self.decode_ranges += 1
        # device ms of the routed expert products under decode steps
        self.expert_us_in_decode = 0.0
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA or \
                    e.name != MOE_SPANS["_experts"]:
                continue
            p = e.cpu_parent
            while p is not None and p.name != "bench.decode_all":
                p = p.cpu_parent
            if p is not None:
                self.expert_us_in_decode += e.device_time_total
        self.device = dev
        self.busy = _merge([(a, b) for _, a, b in dev])
        self.busy_s = sum(b - a for a, b in self.busy)

    def kernel_s(self, symbol: str) -> float:
        return sum(b - a for n, a, b in self.device if symbol in n)

    def top_ops(self, n: int = 10) -> List[list]:
        by: Dict[str, float] = {}
        for name, a, b in self.device:
            by[name] = by.get(name, 0.0) + (b - a)
        return [[k[:64], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """Device idle time inside the window, by what the host was doing
        at each gap's middle: the innermost ``bench.`` span of
        :data:`HOST_LABELS` there, else ``tick (rest)`` inside a tick,
        else ``harness``."""
        gaps, t = [], 0.0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.window_s > t:
            gaps.append((t, self.window_s))
        by: Dict[str, float] = {}
        for a, b in gaps:
            mid = 0.5 * (a + b)
            label = "harness"
            covering = [h for h in self.host if h[1] <= mid <= h[2]]
            inner = [h for h in covering if h[0] in HOST_LABELS]
            if inner:
                label = min(inner, key=lambda h: h[2] - h[1])[0]
            elif any(h[0] == "tick" for h in covering):
                label = "tick (rest)"
            by[label] = by.get(label, 0.0) + (b - a)
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _merge(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out
