"""Arrival traces: the workload half of ``repro_torch.workloads``.

The port's copy of ``repro/workloads/trace.py`` (numpy with explicit
generators, so every column is bit-identical to the reference's on the
same seed), in two interchangeable forms:

  * :class:`ArrivalProcess` — the inline-draw form: a rate function
    ``rate(t)`` the consumer samples its own inter-arrival exponentials
    from, on its own generator (:class:`RampedPoisson`, the simulator's
    default ramp; :class:`StationaryPoisson`, its constant-rate case);
  * :class:`Trace` — the materialized form: per-request arrival time,
    function index, prompt length, decode length and payload bytes as
    parallel numpy columns, from seeded generators (stationary Poisson,
    bursty on/off MMPP, diurnal sinusoid, uniform or Zipf function
    popularity), with a CSV export and replay that either package reads.

Both the simulator (``ContinuumSimulator(..., trace=...)``) and the live
runtime (``Continuum(..., trace=...)``) accept a trace.
"""

from __future__ import annotations

import dataclasses
import io
from typing import List, Optional, Sequence, Tuple

import numpy as np

_CSV_HEADER = "t,fn,prompt_len,max_new,payload_bytes"


class ArrivalProcess:
    """Inline-draw arrival form: a deterministic rate function.

    The consumer owns the RNG and draws one inter-arrival exponential per
    request (``rng.exponential(1 / proc.rate(t))``), exactly as the
    historical rate-parameter code paths did — which is what keeps the
    committed goldens bit-identical when the default arrivals are
    expressed through this interface.
    """

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def __repr__(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True, repr=False)
class RampedPoisson(ArrivalProcess):
    """The paper apparatus' open-loop generator: ``low_rps`` until
    ``ramp_start_s``, linear ramp to ``high_rps`` by ``ramp_end_s`` —
    the simulator's historical default trace, consolidated here."""

    low_rps: float = 2.0
    high_rps: float = 16.0
    ramp_start_s: float = 60.0
    ramp_end_s: float = 240.0

    def rate(self, t: float) -> float:
        if t < self.ramp_start_s:
            return self.low_rps
        if t >= self.ramp_end_s:
            return self.high_rps
        frac = (t - self.ramp_start_s) / (self.ramp_end_s - self.ramp_start_s)
        return self.low_rps + frac * (self.high_rps - self.low_rps)

    def __repr__(self) -> str:
        return (f"RampedPoisson({self.low_rps}->{self.high_rps} rps over "
                f"[{self.ramp_start_s}, {self.ramp_end_s}]s)")


@dataclasses.dataclass(frozen=True, repr=False)
class StationaryPoisson(ArrivalProcess):
    """Constant-rate Poisson arrivals (the stationary special case)."""

    rps: float = 4.0

    def rate(self, t: float) -> float:
        return self.rps

    def __repr__(self) -> str:
        return f"StationaryPoisson({self.rps} rps)"


@dataclasses.dataclass
class Trace:
    """A materialized arrival trace: one row per request.

    Parallel columns (all length R): ``t`` — arrival time in seconds,
    nondecreasing; ``fn`` — index into ``fn_names``; ``prompt_len`` /
    ``max_new`` — request size in tokens; ``payload_bytes`` — the bytes a
    down-chain crossing serializes over the link.  ``duration_s`` bounds
    the trace (arrivals past it are invalid).
    """

    t: np.ndarray
    fn: np.ndarray
    prompt_len: np.ndarray
    max_new: np.ndarray
    payload_bytes: np.ndarray
    fn_names: Tuple[str, ...] = ("fn",)
    duration_s: float = 0.0

    def __post_init__(self):
        self.t = np.asarray(self.t, np.float64)
        self.fn = np.asarray(self.fn, np.int32)
        self.prompt_len = np.asarray(self.prompt_len, np.int32)
        self.max_new = np.asarray(self.max_new, np.int32)
        self.payload_bytes = np.asarray(self.payload_bytes, np.float64)
        n = len(self.t)
        for name in ("fn", "prompt_len", "max_new", "payload_bytes"):
            if len(getattr(self, name)) != n:
                raise ValueError(
                    f"trace column {name!r} has {len(getattr(self, name))} "
                    f"rows, expected {n}")
        if n and np.any(np.diff(self.t) < 0):
            raise ValueError("trace arrival times must be nondecreasing")
        if n and (self.fn.min() < 0 or self.fn.max() >= len(self.fn_names)):
            raise ValueError("trace fn index out of range of fn_names")
        if not self.duration_s:
            self.duration_s = float(self.t[-1]) if n else 0.0

    def __len__(self) -> int:
        return len(self.t)

    def __repr__(self) -> str:
        return (f"Trace({len(self)} requests over {self.duration_s:.1f}s, "
                f"fns={list(self.fn_names)})")

    # -- consumption -------------------------------------------------------
    def window(self, t0: float, t1: float) -> np.ndarray:
        """Row indices of arrivals in ``[t0, t1)`` — the per-tick form the
        live scheduler consumes."""
        return np.arange(np.searchsorted(self.t, t0, side="left"),
                         np.searchsorted(self.t, t1, side="left"))

    def per_tick(self, interval_s: float) -> np.ndarray:
        """(T, F) arrival counts per control interval per function."""
        T = max(int(np.ceil(self.duration_s / interval_s)), 1)
        out = np.zeros((T, len(self.fn_names)), np.int64)
        ticks = np.minimum((self.t / interval_s).astype(np.int64), T - 1)
        np.add.at(out, (ticks, self.fn), 1)
        return out

    def mean_rps(self) -> float:
        return len(self) / self.duration_s if self.duration_s else 0.0

    # -- CSV replay/export -------------------------------------------------
    def to_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(_CSV_HEADER + "\n")
            for i in range(len(self)):
                f.write(f"{self.t[i]:.6f},{self.fn_names[self.fn[i]]},"
                        f"{self.prompt_len[i]},{self.max_new[i]},"
                        f"{self.payload_bytes[i]:.1f}\n")

    @classmethod
    def from_csv(cls, path_or_file) -> "Trace":
        f = (open(path_or_file) if isinstance(path_or_file, str)
             else path_or_file)
        try:
            header = f.readline().strip()
            if header != _CSV_HEADER:
                raise ValueError(
                    f"bad trace CSV header {header!r}, "
                    f"expected {_CSV_HEADER!r}")
            t, names, plen, mnew, pay = [], [], [], [], []
            for line in f:
                line = line.strip()
                if not line:
                    continue
                a, b, c, d, e = line.split(",")
                t.append(float(a))
                names.append(b)
                plen.append(int(c))
                mnew.append(int(d))
                pay.append(float(e))
        finally:
            if isinstance(path_or_file, str):
                f.close()
        fn_names = tuple(dict.fromkeys(names))   # first-seen order
        idx = {n: i for i, n in enumerate(fn_names)}
        return cls(t=np.asarray(t), fn=np.asarray([idx[n] for n in names]),
                   prompt_len=np.asarray(plen), max_new=np.asarray(mnew),
                   payload_bytes=np.asarray(pay),
                   fn_names=fn_names or ("fn",))

    def round_trip(self) -> "Trace":
        """CSV-roundtrip self (tests pin replay fidelity with this)."""
        buf = io.StringIO()
        buf.write(_CSV_HEADER + "\n")
        for i in range(len(self)):
            buf.write(f"{self.t[i]:.6f},{self.fn_names[self.fn[i]]},"
                      f"{self.prompt_len[i]},{self.max_new[i]},"
                      f"{self.payload_bytes[i]:.1f}\n")
        buf.seek(0)
        return Trace.from_csv(buf)

    # -- generators --------------------------------------------------------
    @staticmethod
    def _fill_requests(rng: np.random.Generator, times: np.ndarray,
                       fn_names: Sequence[str], popularity: str,
                       zipf_s: float, prompt_len: int, max_new: int,
                       payload_bytes: float, duration_s: float) -> "Trace":
        """Shared tail of every generator: draw per-request function ids
        (uniform or Zipf-skewed) and attach the size columns."""
        n, F = len(times), len(fn_names)
        if popularity == "zipf":
            w = 1.0 / np.arange(1, F + 1, dtype=np.float64) ** zipf_s
            w /= w.sum()
        elif popularity == "uniform":
            w = np.full(F, 1.0 / F)
        else:
            raise ValueError(
                f"popularity must be 'uniform' or 'zipf', got {popularity!r}")
        fn = rng.choice(F, size=n, p=w) if F > 1 else np.zeros(n, np.int32)
        return Trace(t=times, fn=fn,
                     prompt_len=np.full(n, prompt_len),
                     max_new=np.full(n, max_new),
                     payload_bytes=np.full(n, float(payload_bytes)),
                     fn_names=tuple(fn_names), duration_s=duration_s)

    @classmethod
    def poisson(cls, rps: float, duration_s: float,
                fn_names: Sequence[str] = ("fn",), seed: int = 0,
                popularity: str = "uniform", zipf_s: float = 1.1,
                prompt_len: int = 6, max_new: int = 4,
                payload_bytes: float = 2.0e5) -> "Trace":
        """Stationary Poisson arrivals at ``rps`` for ``duration_s``."""
        rng = np.random.default_rng(seed)
        # one draw per arrival, in arrival order (deterministic length)
        times, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / rps)
            if t >= duration_s:
                break
            times.append(t)
        return cls._fill_requests(rng, np.asarray(times), fn_names,
                                  popularity, zipf_s, prompt_len, max_new,
                                  payload_bytes, duration_s)

    @classmethod
    def bursty(cls, base_rps: float, burst_rps: float, duration_s: float,
               mean_on_s: float = 10.0, mean_off_s: float = 30.0,
               fn_names: Sequence[str] = ("fn",), seed: int = 0,
               popularity: str = "uniform", zipf_s: float = 1.1,
               prompt_len: int = 6, max_new: int = 4,
               payload_bytes: float = 2.0e5) -> "Trace":
        """Bursty on/off arrivals (a 2-state MMPP): ``base_rps`` in the
        off state, ``burst_rps`` during exponentially-distributed on
        periods — the flash-crowd regime."""
        rng = np.random.default_rng(seed)
        times: List[float] = []
        t, on = 0.0, False
        phase_end = rng.exponential(mean_off_s)
        while t < duration_s:
            rate = burst_rps if on else base_rps
            t_next = t + rng.exponential(1.0 / rate)
            if t_next >= phase_end:
                # no arrival this phase remainder: flip state and carry on
                t = phase_end
                on = not on
                phase_end = t + rng.exponential(
                    mean_on_s if on else mean_off_s)
                continue
            t = t_next
            if t < duration_s:
                times.append(t)
        return cls._fill_requests(rng, np.asarray(times), fn_names,
                                  popularity, zipf_s, prompt_len, max_new,
                                  payload_bytes, duration_s)

    @classmethod
    def diurnal(cls, mean_rps: float, duration_s: float,
                period_s: float = 86400.0, amplitude: float = 0.8,
                peak_at_s: float = 0.0,
                fn_names: Sequence[str] = ("fn",), seed: int = 0,
                popularity: str = "uniform", zipf_s: float = 1.1,
                prompt_len: int = 6, max_new: int = 4,
                payload_bytes: float = 2.0e5) -> "Trace":
        """Diurnal sinusoid arrivals via Poisson thinning:
        ``rate(t) = mean * (1 + amplitude * cos(2pi (t-peak)/period))``."""
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
        rng = np.random.default_rng(seed)
        peak = mean_rps * (1.0 + amplitude)
        times, t = [], 0.0
        while True:
            t += rng.exponential(1.0 / peak)
            if t >= duration_s:
                break
            rate = mean_rps * (1.0 + amplitude * np.cos(
                2.0 * np.pi * (t - peak_at_s) / period_s))
            if rng.uniform() * peak < rate:     # thinning acceptance
                times.append(t)
        return cls._fill_requests(rng, np.asarray(times), fn_names,
                                  popularity, zipf_s, prompt_len, max_new,
                                  payload_bytes, duration_s)


def request_rounds(rounds: int, seed: int, max_new: int = 6,
                   warmup_rounds: int = 3, warmup_burst: int = 2,
                   burst: int = 8, prompt_len: int = 6, vocab: int = 128
                   ) -> List[Tuple[int, np.ndarray, int]]:
    """The serving benches' shared tick-indexed request schedule:
    ``(round, tokens, max_new)`` triples — ``warmup_burst`` requests per
    round for the first ``warmup_rounds``, ``burst`` after.

    Defaults reproduce the historical ``serving_bench._workload`` draws
    bit-identically (same RNG, same order), so the committed serving
    goldens are unchanged by the consolidation.
    """
    rng = np.random.default_rng(seed)
    sched = []
    for rnd in range(rounds):
        for _ in range(warmup_burst if rnd < warmup_rounds else burst):
            sched.append((rnd, rng.integers(0, vocab, prompt_len)
                          .astype(np.int32), max_new))
    return sched


def trace_requests(trace: Trace, seed: int = 0, vocab: int = 128,
                   rng: Optional[np.random.Generator] = None
                   ) -> List[np.ndarray]:
    """Materialize per-request prompt tokens for a trace (the live
    runtime serves real tokens; the trace only carries lengths)."""
    rng = rng or np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(n)).astype(np.int32)
            for n in trace.prompt_len]
