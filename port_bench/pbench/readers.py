"""What the per-layer readers (``port_bench/metrics/<name>.py``) share.

Each metric's file is a few lines that pick one of these; a reader
returns ``None`` where there is nothing to read, never a 0 standing in
for a missing share.
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional

from pbench import counts
from pbench.trace import K1_SYMBOL, K2_SYMBOL

Reader = Callable[[object], Optional[float]]
CHILDREN = ("decode_all", "prefill_batch", "controller_update")


def mean_span_ms(name: str) -> Reader:
    def read(run):
        sp = run.spans(name)
        return 1e3 * sum(s.t1 - s.t0 for s in sp) / len(sp) if sp else None
    return read


def tick_overhead_ms() -> Reader:
    """Host ms of a tick outside the spans of :data:`CHILDREN` in it."""
    def read(run):
        ticks = run.spans("tick")
        kids = sorted((s for s in run.rec.spans if s.name in CHILDREN),
                      key=lambda s: s.t0)
        starts = [s.t0 for s in kids]
        own = []
        for t in ticks:
            i = bisect.bisect_left(starts, t.t0)
            inner = 0.0
            while i < len(kids) and kids[i].t0 < t.t1:
                if kids[i].t1 <= t.t1:
                    inner += kids[i].t1 - kids[i].t0
                i += 1
            own.append(t.t1 - t.t0 - inner)
        return 1e3 * sum(own) / len(own) if own else None
    return read


def moe_expert_ms() -> Reader:
    """Device ms of the routed expert products per decode step."""
    def read(run):
        tr = run.trace
        if (tr is None or run.family != "moe"
                or not tr.decode_ranges or not tr.expert_us_in_decode):
            return None
        return tr.expert_us_in_decode / 1e3 / tr.decode_ranges
    return read


def _k2_bound_s(run) -> float:
    s_total = 0.0
    for s in run.traced_spans("decode_all"):
        i = s.info
        if not i["k2"]:
            continue
        f, b = counts.k2_counts(run.conf, i["rows"], i["max_len"], i["live"])
        s_total += i["k2"] * counts.roofline_s(f, b, run.peaks)[0]
    return s_total


def _k1_bound_s(run) -> float:
    s_total = 0.0
    for s in run.traced_spans("prefill_batch"):
        groups = {}
        for L in s.info["lengths"]:
            groups.setdefault(L, []).append(L)
        if not s.info["k1"] or not groups:
            continue
        per_group = s.info["k1"] / len(groups)
        for lens in groups.values():
            f, b = counts.k1_counts(run.conf, lens)
            s_total += per_group * counts.roofline_s(f, b, run.peaks)[0]
    return s_total


def roofline(kernel: str) -> Reader:
    """% of the kernel's device time that its least time from the shapes
    takes (``counts``), over the profiled calls."""
    symbol, bound = {"k1": (K1_SYMBOL, _k1_bound_s),
                     "k2": (K2_SYMBOL, _k2_bound_s)}[kernel]

    def read(run):
        if run.trace is None:
            return None
        t = run.trace.kernel_s(symbol)
        b = bound(run)
        return 100.0 * b / t if t > 0 and b > 0 else None
    return read


def device_idle() -> Reader:
    def read(run):
        tr = run.trace
        if tr is None or tr.window_s <= 0:
            return None
        return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
    return read


def mfu() -> Reader:
    """Useful operations of the profiled calls (``counts.step_flops``)
    over the profiled window's seconds and the bf16 peak, in %."""
    def read(run):
        tr = run.trace
        if tr is None or tr.window_s <= 0:
            return None
        prompts: List[int] = []
        live: List[int] = []
        for s in run.traced_spans("prefill_batch"):
            prompts += s.info["lengths"]
        for s in run.traced_spans("decode_all"):
            live += s.info["live"]
        if not prompts and not live:
            return None
        flops = counts.step_flops(run.conf, prompts, live)
        peak = float(run.peaks["flops_per_s"][run.conf["torch_dtype"]])
        return 100.0 * flops / tr.window_s / peak
    return read
