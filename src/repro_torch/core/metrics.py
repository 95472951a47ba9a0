"""Lightweight metrics registry — the Prometheus stand-in.

The port's own copy of ``repro/core/metrics.py``.

The paper deploys a Prometheus instance per edge cluster with short data
liveness, scraped by the offloading controller. Here each tier keeps ring
buffers of recent observations; the controller reads fixed-size latency
windows from them. Host-side (plain numpy) because this is scrape-cadence
control-plane data.

Storage is one stacked (F, capacity) float32 ring (:class:`VectorWindows`)
rather than F Python deques, so the controller's scrape —
:meth:`MetricsRegistry.latency_windows` — is a single vectorized gather
instead of an O(F) Python loop, and the streaming sketch path can drain
the fresh samples of *all* functions at once (:meth:`VectorWindows.drain_fresh`).
The per-function dict view (``registry.latency[name]``) is preserved as
row views over the shared store, bit-identical to the historical
deque-backed windows.
"""

from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np


class LatencyWindow:
    """Fixed-capacity ring of recent request latencies for one function.

    The standalone (deque-backed) form, kept as the reference semantics
    for :class:`VectorWindows` rows and for callers that track a single
    series outside a registry.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = capacity
        self._buf: Deque[float] = collections.deque(maxlen=capacity)

    def record(self, latency_s: float) -> None:
        self._buf.append(float(latency_s))

    def clear(self) -> None:
        """Drop all recorded observations."""
        self._buf.clear()

    def values(self) -> np.ndarray:
        """All retained observations, oldest first (for percentile
        reports; the controller path uses :meth:`window`)."""
        return np.asarray(self._buf, np.float32)

    def window(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (latencies, valid) padded/masked to ``size``."""
        data = list(self._buf)[-size:]
        lat = np.zeros(size, np.float32)
        valid = np.zeros(size, bool)
        if data:
            lat[: len(data)] = data
            valid[: len(data)] = True
        return lat, valid

    def __len__(self) -> int:
        return len(self._buf)


class VectorWindows:
    """Stacked per-function latency rings: one (F, capacity) float32 array.

    Row ``r`` behaves exactly like a ``LatencyWindow`` (same retention,
    same oldest-first window layout, bit-identical float32 contents); the
    win is that :meth:`windows` reads every function's window in one numpy
    gather — O(F*size) array work with no per-function Python — which is
    what lets one control tick scrape a 10k-function fleet.
    """

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._buf = np.zeros((0, self.capacity), np.float32)
        self._n = np.zeros(0, np.int64)          # total recorded per row
        # Append log since the last drain (streaming sketch ingest).
        self._fresh_rows: List[int] = []
        self._fresh_vals: List[float] = []

    @property
    def num_rows(self) -> int:
        return self._buf.shape[0]

    def add_row(self) -> int:
        """Append one function row; returns its index."""
        self._buf = np.vstack(
            [self._buf, np.zeros((1, self.capacity), np.float32)])
        self._n = np.append(self._n, 0)
        return self._buf.shape[0] - 1

    def record(self, row: int, latency_s: float) -> None:
        v = np.float32(latency_s)
        self._buf[row, self._n[row] % self.capacity] = v
        self._n[row] += 1
        self._fresh_rows.append(row)
        self._fresh_vals.append(float(v))

    def count(self, row: int) -> int:
        """Observations currently retained for ``row`` (deque ``len``)."""
        return int(min(self._n[row], self.capacity))

    def clear_row(self, row: int) -> None:
        self._n[row] = 0

    def clear(self) -> None:
        self._n[:] = 0
        self._fresh_rows.clear()
        self._fresh_vals.clear()

    def values(self, row: int) -> np.ndarray:
        """Retained observations of one row, oldest first."""
        k = self.count(row)
        idx = (self._n[row] - k + np.arange(k)) % self.capacity
        return self._buf[row, idx].astype(np.float32)

    def window(self, row: int, size: int) -> Tuple[np.ndarray, np.ndarray]:
        """(size,) window of one row — same layout as LatencyWindow."""
        lat, valid = self.windows(size, rows=np.asarray([row]))
        return lat[0], valid[0]

    def windows(self, size: int,
                rows: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked (F, size) windows + masks in one vectorized gather.

        Row r's window holds its last ``min(count, size)`` observations
        oldest-first at the start, zero-padded/False-masked after — the
        exact layout of :meth:`LatencyWindow.window`, for every function
        at once.
        """
        n = self._n if rows is None else self._n[rows]
        buf = self._buf if rows is None else self._buf[rows]
        k = np.minimum(np.minimum(n, self.capacity), size)   # (F,)
        j = np.arange(size)[None, :]                         # (1, size)
        idx = ((n - k)[:, None] + j) % self.capacity
        valid = j < k[:, None]
        lat = np.where(
            valid, np.take_along_axis(buf, idx, axis=1), np.float32(0.0))
        return lat.astype(np.float32), valid

    def drain_fresh(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, values) recorded since the last drain, then reset.

        The streaming controller's scrape: each control tick ingests only
        the new samples into the quantile sketch instead of re-reading
        whole windows.
        """
        rows = np.asarray(self._fresh_rows, np.int32)
        vals = np.asarray(self._fresh_vals, np.float32)
        self._fresh_rows.clear()
        self._fresh_vals.clear()
        return rows, vals


class _RowView:
    """LatencyWindow-compatible view of one VectorWindows row (what
    ``registry.latency[name]`` hands out)."""

    __slots__ = ("_vw", "_row")

    def __init__(self, vw: VectorWindows, row: int):
        self._vw = vw
        self._row = row

    @property
    def capacity(self) -> int:
        return self._vw.capacity

    def record(self, latency_s: float) -> None:
        self._vw.record(self._row, latency_s)

    def clear(self) -> None:
        self._vw.clear_row(self._row)

    def values(self) -> np.ndarray:
        return self._vw.values(self._row)

    def window(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        return self._vw.window(self._row, size)

    def __len__(self) -> int:
        return self._vw.count(self._row)


class MetricsRegistry:
    """Per-function latency windows + scalar gauges/counters.

    ``latency[name]`` keeps the historical per-function window API, but
    all rows share one :class:`VectorWindows` store so the controller
    scrape is a single stacked gather.
    """

    def __init__(self, function_names: List[str], capacity: int = 256):
        self.function_names = list(function_names)
        self.windows = VectorWindows(capacity)
        self.latency: Dict[str, _RowView] = {}
        for n in self.function_names:
            self.latency[n] = _RowView(self.windows, self.windows.add_row())
        self.counters: Dict[str, float] = collections.defaultdict(float)
        self.gauges: Dict[str, float] = {}

    def register(self, fn: str, capacity: int = 256) -> None:
        """Add a function after construction (dynamic deployments)."""
        if fn not in self.latency:
            self.function_names.append(fn)
            self.latency[fn] = _RowView(self.windows, self.windows.add_row())

    def record_latency(self, fn: str, latency_s: float) -> None:
        self.latency[fn].record(latency_s)

    def clear(self) -> None:
        """Drop all recorded observations (e.g. after a warmup phase)."""
        self.windows.clear()
        self.counters.clear()
        self.gauges.clear()

    def inc(self, name: str, v: float = 1.0) -> None:
        self.counters[name] += v

    def counter(self, name: str) -> float:
        """Read a counter without materializing it (``counters`` is a
        defaultdict — bare indexing would create zero-valued entries)."""
        return float(self.counters.get(name, 0.0))

    def set_gauge(self, name: str, v: float) -> None:
        self.gauges[name] = v

    def latency_values(self, fn: Optional[str] = None) -> np.ndarray:
        """Retained latency observations for one function (or all of
        them concatenated) — the raw samples benchmark percentiles are
        computed from."""
        if fn is not None:
            return self.latency[fn].values()
        vals = [w.values() for w in self.latency.values()]
        return (np.concatenate(vals) if vals
                else np.zeros(0, np.float32))

    def latency_windows(self, size: int) -> Tuple[np.ndarray, np.ndarray]:
        """Stacked (F, size) latency windows + masks, function-ordered."""
        return self.windows.windows(size)

    def drain_fresh(self) -> Tuple[np.ndarray, np.ndarray]:
        """(fn_rows, values) recorded since the last drain — the
        streaming scrape for ``ControlLoop(eq1="sketch")``."""
        return self.windows.drain_fresh()
