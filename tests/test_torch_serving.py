"""The port's serving engine: the cases of ``tests/test_serving.py`` on
``repro_torch.core.serving`` (CPU, plain kernel versions), plus the JAX
and the port engines replaying one trace with the same parameters.

Policy tests use fake replicas and injected service times on the virtual
timeline; the differential tests use a small 3-layer topology.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.model import ConvLayer as JConvLayer
from repro.core.serving import ServingEngine as JServingEngine
from repro.core.serving import replay as jreplay
from repro.models import layers as jlayers
from repro.models.base import init_params as jinit
from repro_torch.core import serving
from repro_torch.core.model import ConvLayer
from repro_torch.core.serving import (BucketGrid, QueueFull, Replica,
                                      ServingEngine, pow2_buckets, replay)
from repro_torch.models.layers import TrimCNN
from repro_torch.testing.load import (TraceRecorder, burst_arrivals,
                                      poisson_arrivals, ramp_arrivals)

pytestmark = pytest.mark.serving

SPEC = [("t0", 12, 3, 8, 3, 1, 1), ("t1", 12, 8, 8, 3, 2, 1),
        ("t2", 6, 8, 16, 3, 1, 1)]
TOPO = [ConvLayer(*a) for a in SPEC]
RNG = np.random.default_rng(8)


def _engine(**kw):
    kw.setdefault("buckets", (1, 2, 4))
    model = TrimCNN.random(TOPO, n_classes=10, device="cpu")
    return ServingEngine.for_topology(TOPO, model, device="cpu", **kw)


def _echo_replica(name="echo"):
    """A fake replica whose output row encodes the input row."""
    return Replica(name=name, fn=lambda b: np.asarray(b).sum(
        axis=tuple(range(1, np.asarray(b).ndim))))


def _xs(n, shape=(12, 12, 3)):
    return RNG.standard_normal((n,) + shape).astype(np.float32)


def test_bucket_for_is_exact():
    g = BucketGrid.build((1, 2, 4, 8))
    assert [g.bucket_for(n) for n in range(1, 9)] == \
        [1, 2, 4, 4, 8, 8, 8, 8]
    assert [g.pad_rows(n) for n in range(1, 9)] == \
        [0, 0, 1, 0, 3, 2, 1, 0]


def test_bucket_for_bounds():
    g = BucketGrid.build((2, 4))
    assert g.bucket_for(1) == 2
    with pytest.raises(ValueError):
        g.bucket_for(0)
    with pytest.raises(ValueError):
        g.bucket_for(5)
    with pytest.raises(ValueError):
        BucketGrid.build(())
    with pytest.raises(ValueError):
        BucketGrid.build((0, 2))


def test_grid_sorts_and_dedups():
    g = BucketGrid.build((8, 1, 4, 4, 2))
    assert g.buckets == (1, 2, 4, 8) and g.max_bucket == 8


def test_pow2_buckets():
    assert pow2_buckets(8) == (1, 2, 4, 8)
    assert pow2_buckets(6) == (1, 2, 4, 6)
    assert pow2_buckets(1) == (1,)
    with pytest.raises(ValueError):
        pow2_buckets(0)


def test_served_rows_bit_match_single_request_forward():
    eng = _engine()
    eng.prewarm()
    xs = _xs(7)
    trace = [(t, i, xs[i])
             for i, t in enumerate(poisson_arrivals(500.0, 7, seed=3))]
    results, rejected = replay(eng, trace)
    assert not rejected and len(results) == 7
    for i in range(7):
        assert np.array_equal(results[i], eng.forward_one(xs[i])), i


def test_padding_rows_never_leak():
    xs = _xs(3)     # 3 requests -> bucket 4: one padding row
    outs = {}
    for fill in (0.0, 1e9):
        eng = _engine(pad_fill=fill)
        eng.prewarm()
        results, _ = replay(eng, [(0.0, i, xs[i]) for i in range(3)])
        outs[fill] = results
    assert eng.stats()["bucket_batches"] == {4: 1}
    for i in range(3):
        assert np.array_equal(outs[0.0][i], outs[1e9][i]), i


def test_fifo_within_bucket():
    eng = ServingEngine([_echo_replica()], buckets=(1, 2, 4),
                        input_shape=(2,))
    for rid in range(10):
        eng.submit(rid, np.full(2, rid, np.float32), now=float(rid))
    order, t = [], 10.0
    while eng.pending():
        out, dt = eng.step(now=t, service_model=lambda b: 1.0)
        order.extend(rid for rid, _ in out)
        t += dt
    assert order == list(range(10))
    assert [r.rid for r in eng.recorder.completed()] == list(range(10))


def test_backpressure_bounds_queue_depth():
    eng = ServingEngine([_echo_replica()], buckets=(1, 2, 4), max_queue=4)
    for rid in range(4):
        eng.submit(rid, np.zeros(2), now=0.0)
    with pytest.raises(QueueFull):
        eng.submit(99, np.zeros(2), now=0.0)
    assert eng.recorder.max_queue_depth == 4 and eng.pending() == 4
    eng2 = ServingEngine([_echo_replica()], buckets=(1, 2, 4), max_queue=4)
    trace = [(0.0, i, np.zeros(2)) for i in range(12)]
    results, rejected = replay(eng2, trace, service_model=lambda b: 1.0)
    assert len(results) + len(rejected) == 12
    assert eng2.recorder.max_queue_depth <= 4
    assert eng2.stats()["rejected"] == len(rejected)


def test_max_queue_must_fit_a_batch():
    with pytest.raises(ValueError):
        ServingEngine([_echo_replica()], buckets=(1, 8), max_queue=4)


def test_replay_is_deterministic():
    def run():
        eng = ServingEngine([_echo_replica("a"), _echo_replica("b")],
                            buckets=(1, 2, 4))
        trace = [(t, i, np.full(2, i, np.float32)) for i, t in
                 enumerate(ramp_arrivals(5.0, 50.0, 20, seed=7))]
        results, rejected = replay(eng, trace,
                                   service_model=lambda b: 0.05 * b)
        timeline = [(r.rid, r.t_enqueue, r.t_execute, r.t_complete,
                     r.bucket, r.replica)
                    for r in eng.recorder.completed()]
        return results, rejected, timeline

    r1, rej1, tl1 = run()
    r2, rej2, tl2 = run()
    assert tl1 == tl2 and rej1 == rej2
    assert all(np.array_equal(r1[k], r2[k]) for k in r1)


def test_continuous_batching_fills_buckets_under_burst():
    eng = ServingEngine([_echo_replica()], buckets=(1, 2, 4))
    replay(eng, [(0.0, i, np.zeros(2)) for i in range(8)],
           service_model=lambda b: 1.0)
    assert eng.stats()["bucket_batches"] == {4: 2}
    for r in eng.recorder.completed():
        assert r.bucket == 4 and r.batch_real == 4


def test_round_robin_spreads_load_over_replicas():
    eng = ServingEngine([_echo_replica("a"), _echo_replica("b")],
                        buckets=(1,))
    replay(eng, [(float(i), i, np.zeros(2)) for i in range(6)],
           service_model=lambda b: 0.1)
    served = eng.stats()["replicas"]
    assert served["a"]["served"] == 3 and served["b"]["served"] == 3


def test_recorder_lifecycle_and_latency():
    rec = TraceRecorder()
    eng = ServingEngine([_echo_replica()], buckets=(1, 2), recorder=rec)
    eng.submit(0, np.zeros(2), now=1.0)
    eng.submit(1, np.zeros(2), now=1.5)
    out, dt = eng.step(now=2.0, service_model=lambda b: 0.5)
    assert {rid for rid, _ in out} == {0, 1} and dt == 0.5
    r0 = rec.records[0]
    assert (r0.t_enqueue, r0.t_execute, r0.t_complete) == (1.0, 2.0, 2.5)
    assert r0.latency == 1.5 and r0.queue_wait == 1.0
    assert rec.summary()["buckets"][2]["count"] == 2


def test_arrival_generators_are_seed_deterministic():
    assert poisson_arrivals(10.0, 5, seed=4) == \
        poisson_arrivals(10.0, 5, seed=4)
    assert poisson_arrivals(10.0, 5, seed=4) != \
        poisson_arrivals(10.0, 5, seed=5)
    assert burst_arrivals(3, 4, 1.0) == [0.0] * 4 + [1.0] * 4 + [2.0] * 4
    ramp = ramp_arrivals(5.0, 50.0, 10, seed=1)
    assert ramp == sorted(ramp) and len(ramp) == 10


def test_prewarm_eliminates_cold_starts():
    eng = _engine()
    warm = eng.prewarm()
    assert sorted(warm) == [1, 2, 4]
    xs = _xs(5)
    replay(eng, [(0.0, i, xs[i]) for i in range(5)])
    st = eng.stats()
    assert st["cold_tunes"] == 0 and st["prewarmed_buckets"] == [1, 2, 4]
    assert all(not r["degraded"] and r["guard_events"] == []
               for r in st["replicas"].values())


def test_unprewarmed_bucket_counts_as_cold_start():
    eng = _engine()
    xs = _xs(2)
    for t in (0.0, 1.0):
        eng.submit(int(2 * t), xs[0], now=t)
        eng.submit(int(2 * t) + 1, xs[1], now=t)
        eng.step(now=t)
        assert eng.stats()["cold_tunes"] == 1


def test_engine_needs_a_replica_and_unique_rids():
    with pytest.raises(ValueError):
        ServingEngine([], buckets=(1,))
    eng = ServingEngine([_echo_replica()], buckets=(1,))
    eng.submit(0, np.zeros(2), now=0.0)
    with pytest.raises(ValueError):
        eng.submit(0, np.zeros(2), now=0.1)


def test_serving_module_exports_and_stats_keys():
    for name in serving.__all__:
        assert getattr(serving, name) is not None
    jeng = JServingEngine([_echo_replica()], buckets=(1,))
    eng = ServingEngine([_echo_replica()], buckets=(1,))
    assert eng.stats().keys() == jeng.stats().keys()


def test_jax_and_port_engines_replay_one_trace_alike():
    """Same params, same trace, same service model: the same timeline,
    and rows within 1e-5 * max(1, max|logit|) (the JAX engine runs the
    Pallas carry kernel in interpret mode)."""
    jtopo = [JConvLayer(*a) for a in SPEC]
    params = jax.tree.map(np.asarray, jinit(
        jlayers.cnn_params_from_layers(jtopo, n_classes=10),
        jax.random.PRNGKey(0)))
    xs = _xs(6)
    trace = [(t, i, xs[i])
             for i, t in enumerate(poisson_arrivals(300.0, 6, seed=2))]
    model = lambda b: 0.002 * b     # noqa: E731
    jeng = JServingEngine.for_topology(jtopo, params, buckets=(1, 2, 4))
    eng = ServingEngine.for_topology(TOPO, params, buckets=(1, 2, 4),
                                     device="cpu")
    jres, jrej = jreplay(jeng, trace, service_model=model)
    res, rej = replay(eng, trace, service_model=model)
    assert rej == jrej == []

    def timeline(e):
        return [(r.rid, r.t_execute, r.t_complete, r.bucket)
                for r in e.recorder.completed()]

    assert timeline(eng) == timeline(jeng)
    for i in range(6):
        want = np.asarray(jres[i])
        assert res[i].shape == want.shape
        assert np.abs(res[i] - want).max() <= \
            1e-5 * max(1.0, np.abs(want).max())
