"""The port's workload harness against the reference's, on the CPU.

* ``repro_torch.workloads.trace``: every generator's columns are
  bit-identical to ``repro.workloads.trace`` at several seeds, and the
  CSV written by one package replays in the other;
* ``repro_torch.workloads.faults``: ``FaultSchedule.due`` / ``reset`` /
  ``validate`` and ``LinkState``'s effective link match event by event;
* ``repro_torch.core.workloads``: the paper's four FaaS bodies, fed the
  arrays the reference's ``jax.random`` drew, agree with the reference's
  jitted bodies to float32 rounding (rtol 2e-5: the matmul, convolution
  and reduction orders differ between XLA and PyTorch; ``random_io``'s
  scatter-add lands duplicates in another order, exact here because
  every value is a multiple of 0.5 below 2**23, so only its final sum
  rounds differently); ``PROFILES`` equal the reference's constants.
"""

import io

import jax
import numpy as np
import pytest
import torch

from repro.core import topology as j_topo
from repro.core import workloads as j_work
from repro.workloads import faults as j_faults
from repro.workloads import trace as j_trace
from repro_torch.core import topology as t_topo
from repro_torch.core import workloads as t_work
from repro_torch.workloads import faults as t_faults
from repro_torch.workloads import trace as t_trace

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

COLUMNS = ("t", "fn", "prompt_len", "max_new", "payload_bytes")
BODY_TOL = dict(rtol=2e-5, atol=1e-6)


def assert_same_trace(got, want):
    for c in COLUMNS:
        a, b = getattr(got, c), getattr(want, c)
        assert a.dtype == b.dtype, c
        np.testing.assert_array_equal(a, b, err_msg=c)
    assert got.fn_names == want.fn_names
    assert got.duration_s == want.duration_s
    assert repr(got) == repr(want)


_GENERATORS = {
    "poisson": dict(rps=6.0, duration_s=40.0),
    "bursty": dict(base_rps=0.5, burst_rps=8.0, duration_s=30.0,
                   mean_on_s=5.0, mean_off_s=10.0),
    "diurnal": dict(mean_rps=5.0, duration_s=60.0, period_s=30.0,
                    amplitude=0.7, peak_at_s=5.0),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("gen", sorted(_GENERATORS))
def test_trace_generators_are_bit_identical(gen, seed):
    kw = dict(_GENERATORS[gen], seed=seed)
    assert_same_trace(getattr(t_trace.Trace, gen)(**kw),
                      getattr(j_trace.Trace, gen)(**kw))
    kw.update(fn_names=("a", "b", "c", "d"), popularity="zipf", zipf_s=1.3,
              prompt_len=64, max_new=32, payload_bytes=6.0e6)
    got = getattr(t_trace.Trace, gen)(**kw)
    assert_same_trace(got, getattr(j_trace.Trace, gen)(**kw))
    np.testing.assert_array_equal(got.per_tick(1.0),
                                  getattr(j_trace.Trace, gen)(**kw)
                                  .per_tick(1.0))
    assert got.mean_rps() == getattr(j_trace.Trace, gen)(**kw).mean_rps()
    for t0, t1 in ((0.0, 1.0), (2.5, 9.0), (10.0, 10.0)):
        np.testing.assert_array_equal(
            got.window(t0, t1),
            getattr(j_trace.Trace, gen)(**kw).window(t0, t1))


def test_bursty_trace_of_the_chip_phase():
    """The trace chip_smoke.py phase 5f serves: 68 requests in two
    bursts, up to 13 arrivals a tick."""
    kw = dict(base_rps=0.5, burst_rps=8.0, duration_s=30.0, mean_on_s=5.0,
              mean_off_s=10.0, seed=0)
    tr = t_trace.Trace.bursty(**kw)
    assert_same_trace(tr, j_trace.Trace.bursty(**kw))
    per_tick = tr.per_tick(1.0)[:, 0]
    assert len(tr) == 68 and per_tick.max() == 13


def test_trace_csv_replays_across_packages(tmp_path):
    tr_t = t_trace.Trace.poisson(5.0, 20.0, fn_names=("x", "y"), seed=3,
                                 popularity="zipf")
    tr_j = j_trace.Trace.poisson(5.0, 20.0, fn_names=("x", "y"), seed=3,
                                 popularity="zipf")
    tr_t.to_csv(str(tmp_path / "port.csv"))
    tr_j.to_csv(str(tmp_path / "ref.csv"))
    assert ((tmp_path / "port.csv").read_text()
            == (tmp_path / "ref.csv").read_text())
    assert_same_trace(j_trace.Trace.from_csv(str(tmp_path / "port.csv")),
                      t_trace.Trace.from_csv(str(tmp_path / "ref.csv")))
    assert_same_trace(tr_t.round_trip(), tr_j.round_trip())
    with pytest.raises(ValueError, match="bad trace CSV header"):
        t_trace.Trace.from_csv(io.StringIO("t,fn\n1,a\n"))


def test_trace_validation_matches_reference():
    for mod in (t_trace, j_trace):
        with pytest.raises(ValueError, match="nondecreasing"):
            mod.Trace(t=[2.0, 1.0], fn=[0, 0], prompt_len=[1, 1],
                      max_new=[1, 1], payload_bytes=[1.0, 1.0])
        with pytest.raises(ValueError, match="rows"):
            mod.Trace(t=[1.0], fn=[0, 0], prompt_len=[1], max_new=[1],
                      payload_bytes=[1.0])
        with pytest.raises(ValueError, match="fn index"):
            mod.Trace(t=[1.0], fn=[2], prompt_len=[1], max_new=[1],
                      payload_bytes=[1.0])
        with pytest.raises(ValueError, match="popularity"):
            mod.Trace.poisson(1.0, 5.0, popularity="pareto")
        with pytest.raises(ValueError, match="amplitude"):
            mod.Trace.diurnal(1.0, 5.0, amplitude=1.5)


def test_arrival_processes_and_request_helpers_match_reference():
    for pj, pt in ((j_trace.RampedPoisson(), t_trace.RampedPoisson()),
                   (j_trace.RampedPoisson(1.0, 9.0, 5.0, 25.0),
                    t_trace.RampedPoisson(1.0, 9.0, 5.0, 25.0)),
                   (j_trace.StationaryPoisson(3.5),
                    t_trace.StationaryPoisson(3.5))):
        assert repr(pt) == repr(pj)
        for t in (0.0, 4.9, 5.0, 17.3, 60.0, 130.0, 240.0, 500.0):
            assert pt.rate(t) == pj.rate(t)
    got = t_trace.request_rounds(6, seed=4)
    want = j_trace.request_rounds(6, seed=4)
    assert [(r, m) for r, _, m in got] == [(r, m) for r, _, m in want]
    for (_, a, _), (_, b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    tr = t_trace.Trace.bursty(0.5, 8.0, 30.0, seed=2)
    for a, b in zip(t_trace.trace_requests(tr, seed=5, vocab=1000),
                    j_trace.trace_requests(
                        j_trace.Trace.bursty(0.5, 8.0, 30.0, seed=2),
                        seed=5, vocab=1000)):
        np.testing.assert_array_equal(a, b)


def _schedule(mod):
    return mod.merge_schedules(
        mod.edge_brownout(5.0, 12.0, link=0, bw_mult=0.1, rtt_mult=3.0),
        mod.cloud_partition(8.0, 20.0, link=1),
        mod.tier_outage(3.0, 9.0, tier=2), None)


def test_fault_schedule_matches_reference():
    sj, st = _schedule(j_faults), _schedule(t_faults)
    assert repr(st) == repr(sj) and len(st) == len(sj) == 6
    for _ in range(2):                       # a reset rewinds the script
        for now in (0.0, 3.0, 4.0, 8.0, 8.5, 12.0, 30.0):
            got = [(e.t, e.kind, e.target) for e in st.due(now)]
            assert got == [(e.t, e.kind, e.target) for e in sj.due(now)]
            assert st.exhausted == sj.exhausted
        st.reset()
        sj.reset()
    assert st.validate(3) is st
    for mod in (t_faults, j_faults):
        with pytest.raises(ValueError, match="topology has"):
            _schedule(mod).validate(2)
        with pytest.raises(ValueError, match="unknown fault kind"):
            mod.FaultEvent(1.0, "meteor", 0)
        with pytest.raises(ValueError, match=">= 0"):
            mod.FaultEvent(-1.0, "crash_tier", 0)
        with pytest.raises(ValueError, match="must be > 0"):
            mod.FaultEvent(1.0, "degrade_link", 0, bw_mult=0.0)


def test_link_state_matches_reference():
    spec_j = j_topo.LinkSpec(rtt_s=0.005, bandwidth_Bps=50e6)
    spec_t = t_topo.LinkSpec(rtt_s=0.005, bandwidth_Bps=50e6)
    lj, lt = j_faults.LinkState(spec_j), t_faults.LinkState(spec_t)
    events = [("degrade_link", 0.05, 5.0), ("partition_link", 1.0, 1.0),
              ("restore_link", 1.0, 1.0), ("degrade_link", 0.3, 2.0)]
    for kind, bw, rtt in events:
        lj.apply(j_faults.FaultEvent(1.0, kind, 0, bw, rtt))
        lt.apply(t_faults.FaultEvent(1.0, kind, 0, bw, rtt))
        assert repr(lt) == repr(lj)
        assert lt.effective_capacity() == lj.effective_capacity()
        assert lt.bandwidth_Bps == lj.bandwidth_Bps
        assert lt.rtt_s == lj.rtt_s
        assert lt.latency_s(6.0e6) == lj.latency_s(6.0e6)
    with pytest.raises(ValueError, match="not a link fault"):
        lt.apply(t_faults.FaultEvent(1.0, "crash_tier", 0))


# -- the paper's four FaaS bodies ------------------------------------------


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [64, 256])
def test_matmult_body_matches_reference(n):
    key = jax.random.PRNGKey(n)
    a = jax.random.normal(key, (n, n), jax.numpy.float32)
    b = jax.random.normal(jax.random.fold_in(key, 1), (n, n),
                          jax.numpy.float32)
    got = t_work.matmult_body(_t(a), _t(b)).item()
    np.testing.assert_allclose(got, float(j_work.matmult(key, n)),
                               **BODY_TOL)


def _image(key, hw):
    img = jax.random.uniform(key, (1, hw, hw, 3), jax.numpy.float32)
    return _t(img).permute(0, 3, 1, 2).contiguous()      # NHWC -> NCHW


@pytest.mark.parametrize("hw", [32, 128])
def test_image_proc_body_matches_reference(hw):
    key = jax.random.PRNGKey(hw + 1)
    got = t_work.image_proc_body(_image(key, hw)).item()
    np.testing.assert_allclose(got, float(j_work.image_proc(key, hw)),
                               **BODY_TOL)


@pytest.mark.parametrize("n", [1 << 12, 1 << 16])
def test_random_io_body_matches_reference(n):
    key = jax.random.PRNGKey(n)
    idx = jax.random.randint(key, (n // 4,), 0, n)
    got = t_work.random_io_body(_t(idx), n).item()
    np.testing.assert_allclose(got, float(j_work.random_io(key, n)),
                               **BODY_TOL)


@pytest.mark.parametrize("scale", [32, 128])
def test_mixed_body_matches_reference(scale):
    key = jax.random.PRNGKey(scale + 3)
    k1, k2, k3 = jax.random.split(key, 3)
    a = jax.random.normal(k1, (scale, scale), jax.numpy.float32)
    b = jax.random.normal(jax.random.fold_in(k1, 1), (scale, scale),
                          jax.numpy.float32)
    idx = jax.random.randint(k3, (scale * scale // 4,), 0, scale * scale)
    got = t_work.mixed_body(_t(a), _t(b), _image(k2, scale), _t(idx)).item()
    np.testing.assert_allclose(got, float(j_work.mixed(key, scale)),
                               **BODY_TOL)


def test_bodies_run_from_device_draws_and_refuse_a_missing_card():
    for fn, size in ((t_work.matmult, 32), (t_work.image_proc, 16),
                     (t_work.random_io, 256), (t_work.mixed, 16)):
        a = fn(size, seed=1, device="cpu")
        assert a.shape == () and torch.isfinite(a)
        assert torch.equal(a, fn(size, seed=1, device="cpu"))
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                fn(size)


def test_profiles_match_reference():
    assert sorted(t_work.PROFILES) == sorted(j_work.PROFILES)
    for name, pj in j_work.PROFILES.items():
        pt = t_work.PROFILES[name]
        for f in ("name", "edge_service_s", "cloud_service_s",
                  "payload_bytes", "mem_mb", "cv"):
            assert getattr(pt, f) == getattr(pj, f), (name, f)
        assert pt.fn.__name__ == pj.fn.__name__
