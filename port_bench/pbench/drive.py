"""Driving the port: the continuum built from a cell's files, the spans
the benchmark puts around the calls into each layer, and the closed
loop on the wall clock.

Spans (host clock, ``time.perf_counter``) are recorded around:

* ``tick``: one ``Continuum.tick()`` from the harness;
* ``decode_all`` / ``prefill_batch``: each tier's ``Endpoint`` calls,
  wrapped on the instance (the argmax read-back ends both, so their
  wall is the work's);
* ``controller_update``: the Eqs (1)-(4) scrape-and-update of a tick;
* ``submit``: the ingress gateway call.

Under a trace every span is also a ``torch.profiler.record_function``
range ``bench.<name>``, so the trace can tell what the host was doing
while the device sat idle.  A decode step records, beside its span, the
rows that stepped and the keys each had live, and the kernels it
launched (the port's ``kernels.ops.launches``); a prefill records its
prompts' lengths.  Nothing here edits the port: wrappers are set on
instances this run built.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from pbench import traffic as gen


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    tier: str = ""
    info: Optional[dict] = None


class Recorder:
    """The run's spans, in the order they ended."""

    def __init__(self, traced: bool):
        self.spans: List[Span] = []
        self.traced = traced

    @contextlib.contextmanager
    def span(self, name: str, tier: str = "", info: Optional[dict] = None):
        rf = None
        if self.traced:
            import torch
            rf = torch.profiler.record_function("bench." + name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield info
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.spans.append(Span(name, t0, t1, tier, info))

    def of(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


def build_continuum(cell, cfg, params, seed: int, device: str):
    """The cell's two-tier continuum (``Continuum(edge=..., cloud=...)``),
    its one function deployed over the benchmark's weights."""
    from repro_torch.platform import (AutoscalingPolicy, Continuum,
                                      FunctionSpec, TierConfig)
    tiers, mix = cell.config["tiers"], cell.traffic
    max_len = cell.max_len()
    cc = Continuum(edge=TierConfig(slots=int(tiers["edge_slots"]),
                                   max_len=max_len),
                   cloud=TierConfig(slots=int(tiers["cloud_slots"]),
                                    max_len=max_len),
                   policy=mix["policy"], seed=int(seed) % 2 ** 63,
                   device=device,
                   max_steps_per_tick=int(mix["max_steps_per_tick"]))
    # provisioned concurrency: the KPA holds every slot of both tiers
    # (min_scale = max_scale), so admission is bounded by slots alone
    scale = int(tiers["kpa_scale"])
    cc.deploy(FunctionSpec(name="fn", arch=cfg.name,
                           autoscaling=AutoscalingPolicy(
                               min_scale=scale, max_scale=scale,
                               target_concurrency=float(
                                   tiers["kpa_target_concurrency"]))),
              cfg, params)
    return cc


def instrument(cc, rec: Recorder, served_by: Dict[int, str]) -> None:
    """Wrap each tier's endpoint and the controller of ``cc`` with spans
    (see the module's docstring)."""
    from repro_torch.kernels import ops
    for tier in cc.tiers:
        ep = tier.endpoints["fn"]

        def decode_all(tokens_by_slot, _ep=ep, _fn=ep.decode_all,
                       _tier=tier.name):
            live = [int(_ep.slot_pos[s]) + 1 for s in tokens_by_slot]
            k2 = ops.launches["decode_attention"]
            info = {"rows": _ep.slots, "max_len": _ep.max_len, "live": live}
            with rec.span("decode_all", _tier, info):
                out = _fn(tokens_by_slot)
            info["k2"] = ops.launches["decode_attention"] - k2
            info["tokens"] = len(out)
            return out

        def prefill_batch(prompts, _fn=ep.prefill_batch, _tier=tier.name):
            for toks in prompts.values():
                served_by[id(toks)] = _tier
            k1 = ops.launches["flash_attention"]
            info = {"lengths": [len(t) for t in prompts.values()]}
            with rec.span("prefill_batch", _tier, info):
                out = _fn(prompts)
            info["k1"] = ops.launches["flash_attention"] - k1
            info["tokens"] = len(out)
            return out

        ep.decode_all = decode_all
        ep.prefill_batch = prefill_batch

    def controller_update(_fn=cc.controller_update):
        with rec.span("controller_update"):
            return _fn()

    cc.controller_update = controller_update


class Profiler:
    """A ``torch.profiler`` window opened and closed from inside a loop,
    the device synchronised at both ends so the trace holds the work of
    exactly the calls made while it was open."""

    def __init__(self, start_at: float, seconds: float, on_card: bool = True):
        self.start_at, self.seconds, self.on_card = start_at, seconds, on_card
        self.prof = None
        self.t0 = self.t1 = None

    def _activities(self):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def prime(self) -> None:
        """Open and close one profiler session in set-up: the first start
        of the device tracer takes seconds, which would otherwise fall
        inside the window."""
        import torch
        with torch.profiler.profile(activities=self._activities()):
            x = torch.ones(8, device="cuda" if self.on_card else "cpu")
            (x + x).sum().item()

    def poll(self, now: float) -> None:
        import torch
        if self.prof is None and now >= self.start_at:
            if self.on_card:
                torch.cuda.synchronize()
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self.t0 = time.perf_counter()
        elif self.prof is not None and self.t1 is None and \
                time.perf_counter() >= self.t0 + self.seconds:
            self.close()

    def close(self) -> None:
        import torch
        if self.prof is not None and self.t1 is None:
            if self.on_card:
                torch.cuda.synchronize()
            self.t1 = time.perf_counter()
            self.prof.stop()


@dataclasses.dataclass
class Sent:
    """One request the harness sent: its plan, its Request, and when it
    was submitted (host clock)."""
    plan: gen.Planned
    req: object
    submitted: float

    @property
    def done(self) -> bool:
        return self.req.output is not None and self.req.t_done > 0

    @property
    def failed(self) -> bool:
        return bool(self.req.failed)


def _submit(cc, rec, plan, seed, vocab) -> Sent:
    from repro_torch.platform import Request
    toks = gen.prompt_tokens(seed, plan.index, plan.prompt_len, vocab)
    req = Request(rid=plan.index, tokens=toks, max_new=plan.max_new)
    with rec.span("submit"):
        t_sub = time.perf_counter()
        cc.submit("fn", req)
    return Sent(plan, req, t_sub)


def _tick(cc, rec) -> None:
    with rec.span("tick"):
        cc.tick()


def run_closed(cc, rec, mix, seconds, seed, vocab, profiler=None) -> dict:
    """The closed loop: each client sends its next request at the first
    loop turn after its last one is done (or refused), from its start in
    the pre-roll until the window closes.  Then no client sends again,
    and the loop ticks on until requests holding ``sample_tokens`` served
    tokens (and two requests at least) are done, for at most the mix's
    ``drain_cap_s``: the comparison's sample is drawn from what finished;
    what is still in flight then is left."""
    sizes = gen.closed_sizes(mix, seed)
    n = int(mix["clients"])
    w0 = float(mix["preroll_s"])
    w1 = w0 + float(seconds)
    starts = [gen.client_start(mix, c) for c in range(n)]
    nxt = [0] * n
    cur: List[Optional[Sent]] = [None] * n
    sent: List[Sent] = []
    t_start = time.perf_counter()
    while True:
        now = time.perf_counter() - t_start
        if profiler is not None:
            profiler.poll(now)
        if now >= w1:
            break
        for c in range(n):
            s = cur[c]
            if now < starts[c] or (s is not None and not (s.done or s.failed)):
                continue
            p_len, m_new = sizes[c][nxt[c] % len(sizes[c])]
            nxt[c] += 1
            plan = gen.Planned(len(sent), p_len, m_new)
            cur[c] = _submit(cc, rec, plan, seed, vocab)
            sent.append(cur[c])
        if cc.queued or cc.in_flight:
            _tick(cc, rec)
        else:
            time.sleep(0.001)
    if profiler is not None:
        profiler.close()
    cap = time.perf_counter() + float(mix["drain_cap_s"])
    while cc.queued or cc.in_flight:
        done = [s for s in sent if s.done]
        if (len(done) >= 2 and sum(s.plan.max_new for s in done)
                >= int(mix["sample_tokens"])) or time.perf_counter() >= cap:
            break
        _tick(cc, rec)
    return {"sent": sent, "w0": t_start + w0, "w1": t_start + w1}


def warm_up(cc, cell, seed: int, vocab: int) -> None:
    """Every endpoint runs the prefill shapes its traffic will use (one
    prompt at each power-of-two length bucket the mix's lengths reach;
    two at once, for the batched path) and a few decode steps, then
    gives its slots back.  The pre-roll that follows warms the rest."""
    lo, hi = cell.traffic["prompt_len"]
    lengths = sorted({min(max(lo, 1 << b), hi)
                      for b in range(int(np.log2(max(lo, 1))),
                                     int(np.ceil(np.log2(hi))) + 1)})
    rng = np.random.default_rng([int(seed) % 2 ** 63, 4])
    for tier in cc.tiers:
        ep = tier.endpoints["fn"]
        for L in lengths:
            for batch in (1, 2):
                slots = [ep.try_claim() for _ in range(batch)]
                toks = ep.prefill_batch({
                    s: rng.integers(0, vocab, L).astype(np.int32)
                    for s in slots})
                for _ in range(2):
                    toks = ep.decode_all(toks)
                for s in slots:
                    ep.release(s)
