"""Deterministic load-test harness for the serving engine (copied from
``repro/testing/load.py``; DESIGN.md §10).

Load tests must never depend on wall-clock: a CI box under contention
would turn every latency assertion flaky.  This module supplies the two
deterministic halves the serving tests and ``chip_smoke.py`` share:

* **Seeded arrival generators** — :func:`poisson_arrivals` (open-loop
  exponential gaps), :func:`burst_arrivals` (synchronized request
  storms) and :func:`ramp_arrivals` (linearly increasing rate) all
  derive every timestamp from a ``numpy`` generator seeded by the
  caller, so the same seed always produces byte-identical traces.

* **A request-lifecycle recorder** — :class:`TraceRecorder` holds one
  :class:`RequestRecord` per request with its
  enqueue/batch/execute/complete timestamps (plus the bucket and
  replica that served it), and aggregates them into the latency
  percentiles and throughput the benchmark emits.

Timestamps are plain floats on whatever clock the caller drives —
:class:`VirtualClock` for the deterministic tests and replays,
``time.monotonic`` for the asyncio server in ``launch/serve_conv.py``.
The recorder never reads a clock itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "VirtualClock", "RequestRecord", "TraceRecorder",
    "poisson_arrivals", "burst_arrivals", "ramp_arrivals",
]


class VirtualClock:
    """A monotonic clock the test harness advances by hand.

    ``now()`` mirrors ``time.monotonic()`` so the serving engine can take
    either interchangeably; ``advance_to`` refuses to move backwards
    (virtual time is monotone, exactly like the real clock it stands in
    for)."""

    def __init__(self, start: float = 0.0) -> None:
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance by {dt} (< 0)")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        if t < self._now:
            raise ValueError(f"cannot rewind to {t} (now {self._now})")
        self._now = float(t)
        return self._now


# ---------------------------------------------------------------------------
# Seeded arrival generators (open-loop: arrivals ignore service progress)
# ---------------------------------------------------------------------------

def poisson_arrivals(rate: float, n: int, *, seed: int = 0,
                     start: float = 0.0) -> list[float]:
    """``n`` Poisson-process arrival times at ``rate`` requests/second:
    i.i.d. exponential inter-arrival gaps, cumulatively summed from
    ``start``.  Deterministic per ``seed``."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return [float(t) for t in start + np.cumsum(gaps)]


def burst_arrivals(n_bursts: int, burst_size: int, gap: float, *,
                   jitter: float = 0.0, seed: int = 0,
                   start: float = 0.0) -> list[float]:
    """``n_bursts`` storms of ``burst_size`` near-simultaneous requests,
    ``gap`` seconds apart.  ``jitter`` spreads each burst's requests
    uniformly over ``[0, jitter)`` after the burst instant (0.0 keeps
    them exactly simultaneous — the FIFO-order stress case)."""
    if n_bursts < 0 or burst_size < 0:
        raise ValueError("n_bursts and burst_size must be >= 0")
    if gap < 0 or jitter < 0:
        raise ValueError("gap and jitter must be >= 0")
    rng = np.random.default_rng(seed)
    times: list[float] = []
    for b in range(n_bursts):
        t0 = start + b * gap
        offs = rng.uniform(0.0, jitter, size=burst_size) if jitter \
            else np.zeros(burst_size)
        times.extend(float(t0 + o) for o in np.sort(offs))
    return times


def ramp_arrivals(rate0: float, rate1: float, n: int, *, seed: int = 0,
                  start: float = 0.0) -> list[float]:
    """``n`` arrivals whose instantaneous rate ramps linearly from
    ``rate0`` to ``rate1`` over the trace: the i-th gap is exponential
    at the interpolated rate.  Models a traffic ramp-up (or drain, when
    ``rate1 < rate0``)."""
    if rate0 <= 0 or rate1 <= 0:
        raise ValueError("rates must be > 0")
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    rng = np.random.default_rng(seed)
    t, times = float(start), []
    for i in range(n):
        frac = i / max(n - 1, 1)
        rate = rate0 + (rate1 - rate0) * frac
        t += float(rng.exponential(1.0 / rate))
        times.append(t)
    return times


# ---------------------------------------------------------------------------
# Request lifecycle recording
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestRecord:
    """One request's lifecycle timestamps (all on the caller's clock).

    ``t_enqueue`` is stamped at submission, ``t_batch`` when the batcher
    pulled the request into a bucket, ``t_execute`` when its batch
    started executing, ``t_complete`` when the batch's results were
    published.  ``bucket``/``replica`` identify the compiled program and
    replica that served it; ``batch_real`` is how many real (non-pad)
    rows shared the batch."""

    rid: int
    t_enqueue: float
    t_batch: float | None = None
    t_execute: float | None = None
    t_complete: float | None = None
    bucket: int | None = None
    replica: str | None = None
    batch_real: int | None = None

    @property
    def latency(self) -> float:
        """Total enqueue-to-complete latency (the number users feel)."""
        if self.t_complete is None:
            raise ValueError(f"request {self.rid} never completed")
        return self.t_complete - self.t_enqueue

    @property
    def queue_wait(self) -> float:
        """Time spent queued before the batch started executing."""
        if self.t_execute is None:
            raise ValueError(f"request {self.rid} never executed")
        return self.t_execute - self.t_enqueue


class TraceRecorder:
    """Collects :class:`RequestRecord` lifecycles plus queue-depth and
    rejection accounting; aggregates the summary the benchmark emits."""

    def __init__(self) -> None:
        self.records: dict[int, RequestRecord] = {}
        self.rejected: list[tuple[int, float]] = []
        self.max_queue_depth = 0

    # -- lifecycle hooks (called by the engine) -----------------------------

    def enqueue(self, rid: int, t: float) -> RequestRecord:
        if rid in self.records:
            raise ValueError(f"duplicate request id {rid}")
        rec = RequestRecord(rid=rid, t_enqueue=t)
        self.records[rid] = rec
        return rec

    def batch(self, rid: int, t: float, *, bucket: int, replica: str,
              batch_real: int) -> None:
        rec = self.records[rid]
        rec.t_batch, rec.bucket = t, bucket
        rec.replica, rec.batch_real = replica, batch_real

    def execute(self, rid: int, t: float) -> None:
        self.records[rid].t_execute = t

    def complete(self, rid: int, t: float) -> None:
        rec = self.records[rid]
        if rec.t_complete is not None:
            raise ValueError(f"request {rid} completed twice")
        rec.t_complete = t

    def reject(self, rid: int, t: float) -> None:
        self.rejected.append((rid, t))

    def note_queue_depth(self, depth: int) -> None:
        self.max_queue_depth = max(self.max_queue_depth, depth)

    # -- aggregation --------------------------------------------------------

    def completed(self) -> list[RequestRecord]:
        """Completed records in completion order (ties: enqueue order)."""
        done = [r for r in self.records.values() if r.t_complete is not None]
        return sorted(done, key=lambda r: (r.t_complete, r.t_enqueue,
                                           r.rid))

    def latencies(self) -> list[float]:
        return [r.latency for r in self.completed()]

    def percentile(self, p: float) -> float:
        lat = self.latencies()
        if not lat:
            raise ValueError("no completed requests")
        return float(np.percentile(np.asarray(lat), p))

    def summary(self) -> dict:
        """The aggregate the benchmark reports: counts, latency
        percentiles (seconds), open-loop throughput (completions per
        second of timeline between first enqueue and last completion),
        and the per-bucket breakdown."""
        done = self.completed()
        out = {"count": len(done), "rejected": len(self.rejected),
               "max_queue_depth": self.max_queue_depth}
        if not done:
            return out
        lat = np.asarray([r.latency for r in done])
        t0 = min(r.t_enqueue for r in done)
        t1 = max(r.t_complete for r in done)
        span = max(t1 - t0, 1e-12)
        buckets: dict[int, list[float]] = {}
        for r in done:
            buckets.setdefault(int(r.bucket), []).append(r.latency)
        out.update(
            p50_s=float(np.percentile(lat, 50)),
            p99_s=float(np.percentile(lat, 99)),
            mean_s=float(lat.mean()),
            max_s=float(lat.max()),
            throughput_rps=len(done) / span,
            span_s=float(span),
            buckets={b: {"count": len(ls),
                         "p50_s": float(np.percentile(np.asarray(ls), 50)),
                         "p99_s": float(np.percentile(np.asarray(ls), 99))}
                     for b, ls in sorted(buckets.items())})
        return out
