"""One run of one cell: set-up, pre-roll, the measured window (a closed
loop), the drain, the comparison that decides ``correct``, and the
result line.

:func:`run_cell` is the whole run with the device given; ``run.py``
checks for the card first and prints what this returns.
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time
from typing import Callable, Dict, List, Optional

from pbench import correct, drive, model, spec
from pbench import trace as tracing

#: seconds of the window under the profiler in a ``--trace 1`` run, ending
#: half a second before the window closes (the host's per-layer spans
#: are read from the part of the window before it: the profiler slows
#: the host)
TRACE_S = 3.0
TRACE_BEFORE_END_S = 0.5
#: the module names a run must not have loaded (whole top-level names)
BANNED = ("jax", "jaxlib", "flax", "repro")


class Run:
    """What the per-layer readers read: the cell, the spans, the sent
    requests, the tick records and, in a traced run, the trace."""

    def __init__(self, cell, conf, rec, res, ticks, trace, prof_span):
        self.cell, self.conf, self.rec, self.res = cell, conf, rec, res
        self.ticks = ticks            # [(tick span, tick record)]
        self.trace = trace            # tracing.Trace or None
        self.prof_span = prof_span    # (t0, t1) host clock, or None
        self.peaks = spec.peaks()
        self.family = conf["family"]

    @property
    def w0(self) -> float:
        return self.res["w0"]

    @property
    def w1(self) -> float:
        return self.res["w1"]

    def _outside_trace(self, a: float, b: float) -> bool:
        """Whether [a, b] ends before the profiler opened (what follows it
        waits on the host's slowed loop)."""
        return self.prof_span is None or b < self.prof_span[0] - 0.05

    def spans(self, name: str, untraced: bool = True) -> List[drive.Span]:
        """The window's spans of ``name`` (by default those outside the
        profiler's interval, which the profiler slows)."""
        return [s for s in self.rec.of(name)
                if s.t0 >= self.w0 and s.t1 <= self.w1
                and (not untraced or self._outside_trace(s.t0, s.t1))]

    def traced_spans(self, name: str) -> List[drive.Span]:
        """The spans of ``name`` made while the profiler was open."""
        if self.prof_span is None:
            return []
        t0, t1 = self.prof_span
        return [s for s in self.rec.of(name) if s.t0 >= t0 and s.t1 <= t1]


def _end_to_end(cell, res, rec, seconds: float, setup_s: float) -> dict:
    out = {"setup_s": {"value": setup_s, "unit": "s"}}
    names = {m["name"] for m in cell.end_to_end}
    if "tokens_per_s" in names:
        n = sum(s.info["tokens"] for s in rec.spans
                if s.name in ("decode_all", "prefill_batch")
                and res["w0"] <= s.t1 <= res["w1"])
        out["tokens_per_s"] = {"value": n / seconds, "unit": "tokens/s"}
    return out


def _counted(res):
    """(attempted, failed) of the window: the requests the window worked
    on (sent before it closed and not done before it opened), and those
    of them refused."""
    w0, w1 = res["w0"], res["w1"]
    alive = [s for s in res["sent"] if s.submitted <= w1
             and not (s.done and s.req.t_done < w0)]
    return len(alive), sum(1 for s in alive if s.failed)


def run_cell(cell, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: Optional[float] = None,
             overrides: Optional[dict] = None,
             fault: Optional[Callable] = None, log=print,
             stash: Optional[dict] = None) -> dict:
    """One run; returns the result line's object.  ``overrides`` replace
    configuration keys (the CPU rehearsal's tiny widths); ``fault``, given,
    is called with the continuum after it is instrumented (a test's
    broken path).  ``stash``, given, receives the weights, the
    configuration and the compared sample (the calibration reads the
    control on them)."""
    import torch
    t_process = time.perf_counter() if t_process is None else t_process
    on_card = device != "cpu"
    conf = {**cell.config, **(overrides or {})}
    cfg = model.model_config(conf)
    vocab = cfg.vocab_size
    params = model.draw_weights(cfg, conf, seed, device)
    cc = drive.build_continuum(cell, cfg, params, seed, device)
    drive.warm_up(cc, cell, seed, vocab)
    if on_card:
        torch.cuda.synchronize()
    rec = drive.Recorder(traced=trace)
    served_by: Dict[int, str] = {}
    drive.instrument(cc, rec, served_by)
    if fault is not None:
        fault(cc)
    t_prof = min(TRACE_S, 0.5 * seconds)
    profiler = (drive.Profiler(float(cell.traffic["preroll_s"]) + seconds
                               - TRACE_BEFORE_END_S - t_prof, t_prof, on_card)
                if trace else None)
    if profiler is not None:
        profiler.prime()
    spans_ctx = (tracing.moe_spans() if trace and conf["family"] == "moe"
                 else contextlib.nullcontext())
    with spans_ctx:
        res = drive.run_closed(cc, rec, cell.traffic, seconds, seed, vocab,
                               profiler)
    if on_card:
        torch.cuda.synchronize()
    setup_s = res["w0"] - t_process
    metrics = _end_to_end(cell, res, rec, seconds, setup_s)
    attempted, failed = _counted(res)
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1 if on_card else 0,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if on_card else 0}
    out = {"correct": False, "attempted": attempted, "failed": failed}
    if trace:
        pspan = (profiler.t0, profiler.t1)
        t_read = time.perf_counter()
        tr = tracing.Trace(profiler.prof, profiler.t1 - profiler.t0)
        profiler.prof = None
        ticks = list(zip(rec.of("tick"), cc.log))
        run = Run(cell, conf, rec, res, ticks, tr, pspan)
        metrics = spec.read_per_layer(cell, run)
        if stash is not None:
            stash["run"] = run
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(),
                            "idle_gaps": tr.idle_gaps()}
        log(f"trace: {len(tr.device)} device events over "
            f"{tr.window_s:.3f} s read in "
            f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    if not on_card:
        # a CPU run reads its trace (the readers' rehearsal) but reports
        # no number under a device metric's name
        metrics, out["cpu_metrics"] = {}, metrics
        dev.pop("busy_s", None)
        dev.pop("window_s", None)
        out.pop("breakdown", None)
    out["metrics"] = metrics
    out["device"] = dev
    # the comparison, once the program's state is freed
    done = [s for s in res["sent"] if s.done]
    picked = correct.sample(done, served_by, seed,
                            int(cell.traffic["sample_tokens"]))
    bad = correct.well_formed(res["sent"], vocab)
    tiers = sorted({served_by.get(id(s.req.tokens), "?") for s in picked})
    del cc, res, rec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    got = correct.served_gaps(conf, params, picked, device)
    # the numbers the cell's limit file bounds (a cell without one has
    # no limit and is not correct)
    named = [n for n in correct.COMPARED if n in cell.limits] or \
        ["max_logit_gap"]
    checks = {name: {"value": got[name],
                     "limit": float(cell.limits.get(name, math.nan))}
              for name in named}
    checks["malformed_outputs"] = {"value": bad, "limit": 0}
    if stash is not None:
        stash.update(params=params, conf=conf, picked=picked, gaps=got)
    out["correct"] = bool(all(c["value"] <= c["limit"]
                              for c in checks.values())
                          and len(picked) >= 1)
    out["checks"] = checks
    log(f"compared {len(picked)} requests, "
        f"{sum(len(s.req.output) for s in picked)} served tokens, served by "
        f"{tiers}", file=sys.stderr)
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})",
            file=sys.stderr)
    return out


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BANNED})
