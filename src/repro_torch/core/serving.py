"""Continuous-batching serving engine over the port's conv stack
(the counterpart of ``repro/core/serving.py``; DESIGN.md §10).

Requests enter a bounded FIFO queue and are served in *buckets* — a fixed
grid of batch sizes.  Each serving step drains up to ``max_bucket``
queued requests, rounds the count up to the smallest bucket that fits,
pads the short rows, executes on the next free replica, and returns only
the real rows — padding never leaks (each output element of the conv
kernels is one fixed-order fp32 sum, and the head runs row by row, so
every served row is bit-identical to the single-request forward; tested
in ``tests/test_torch_serving.py`` and on the card by ``chip_smoke.py``).

* **Deterministic core, async shell.**  :class:`ServingEngine` is a
  synchronous state machine — ``submit(rid, x, now)`` and
  ``step(now=...)`` take explicit timestamps, so :func:`replay` can drive
  an arrival trace on a virtual clock (``repro_torch.testing.load``) with
  *injected* service times and reproduce a timeline bit-for-bit.  The
  asyncio front end (``repro_torch.launch.serve_conv``) wraps the same
  engine with ``time.monotonic`` and real futures.

* **No cold paths after prewarm.**  ``prewarm()`` runs one throwaway
  forward per (bucket, replica), which builds the kernels on first use,
  so no request pays for a build.  A bucket served without prewarm is
  counted in ``stats()`` as a cold start (``cold_tunes``, the JAX
  engine's key; the autotune sweep of the JAX ``prewarm`` waits for the
  autotune port).

* **Nothing degrades.**  The port has no tier chain: a kernel that fails
  raises, so ``guard_events`` in ``stats()`` stay empty and no replica is
  ever reported degraded.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

import numpy as np
import torch

from repro_torch.convert import params_from_jax
from repro_torch.device import resolve_device
from repro_torch.models.layers import TrimCNN
from repro_torch.testing.load import TraceRecorder

__all__ = ["QueueFull", "BucketGrid", "Replica", "ServingEngine",
           "replay", "pow2_buckets"]


class QueueFull(RuntimeError):
    """Raised by :meth:`ServingEngine.submit` when the bounded request
    queue is at capacity — the backpressure signal (shed or retry
    upstream; the engine never buffers unboundedly)."""


def pow2_buckets(max_batch: int) -> tuple[int, ...]:
    """The default bucket grid: powers of two up to (and including)
    ``max_batch`` — ``pow2_buckets(8) == (1, 2, 4, 8)``, and a non-power
    ``max_batch`` is appended as its own bucket (``(1, 2, 4, 6)`` for
    6) so the configured serving batch always has an exact program."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    buckets = []
    b = 1
    while b < max_batch:
        buckets.append(b)
        b *= 2
    buckets.append(max_batch)
    return tuple(buckets)


@dataclasses.dataclass(frozen=True)
class BucketGrid:
    """The fixed grid of serving batch sizes (ascending, unique).

    One compiled program exists per bucket; :meth:`bucket_for` is the
    entire batching policy — exact and deterministic: the smallest
    bucket that fits ``n`` requests (a request count above ``max_bucket``
    is the caller's split problem; the engine never takes more than
    ``max_bucket`` per step)."""

    buckets: tuple[int, ...]

    @classmethod
    def build(cls, buckets) -> "BucketGrid":
        bs = sorted({int(b) for b in buckets})
        if not bs:
            raise ValueError("bucket grid cannot be empty")
        if bs[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {bs[0]}")
        return cls(buckets=tuple(bs))

    @property
    def max_bucket(self) -> int:
        return self.buckets[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= ``n`` (raises for n < 1 or n > max)."""
        if n < 1:
            raise ValueError(f"need at least 1 request, got {n}")
        for b in self.buckets:
            if b >= n:
                return b
        raise ValueError(
            f"{n} requests exceed the largest bucket {self.max_bucket}; "
            "the engine drains at most max_bucket per step")

    def pad_rows(self, n: int) -> int:
        """How many padding rows bucket selection adds for ``n`` real
        requests."""
        return self.bucket_for(n) - n


@dataclasses.dataclass(frozen=True)
class Replica:
    """One serving replica: a name (for stats attribution) and a
    batch forward ``fn(batch) -> outputs`` (row i of the output serves
    request i).  Replicas are data-parallel copies — the engine
    dispatches whole buckets to whichever is free."""

    name: str
    fn: object     # Callable[[np.ndarray], array-like]


class ServingEngine:
    """Continuous batching over a bucket grid with bounded queueing,
    multi-replica dispatch and per-replica reporting.

    The engine is clock-agnostic: every mutating entry point takes
    ``now`` (seconds on the caller's clock).  Thread-safe for the
    asyncio front end (one lock guards the queue and bookkeeping; the
    forward itself runs outside the lock).
    """

    def __init__(self, replicas, buckets, *, max_queue: int = 1024,
                 pad_fill: float = 0.0, input_shape=None,
                 recorder: TraceRecorder | None = None) -> None:
        self.replicas = list(replicas)
        if not self.replicas:
            raise ValueError("need at least one replica")
        self.grid = buckets if isinstance(buckets, BucketGrid) \
            else BucketGrid.build(buckets)
        if max_queue < self.grid.max_bucket:
            raise ValueError(
                f"max_queue {max_queue} < max bucket "
                f"{self.grid.max_bucket}: the queue could never fill a "
                "full batch")
        self.max_queue = int(max_queue)
        self.pad_fill = float(pad_fill)
        self.input_shape = tuple(input_shape) if input_shape else None
        self.recorder = recorder or TraceRecorder()

        self._lock = threading.Lock()
        self._queue: deque = deque()      # (rid, x, t_enqueue)
        self._rr = 0                      # round-robin replica cursor
        self._warm: set[int] = set()
        self.cold_tunes = 0
        self.served = 0
        self._bucket_counts: dict[int, int] = {}
        self._replica_served = {r.name: 0 for r in self.replicas}

    # -- construction -------------------------------------------------------

    @classmethod
    def for_topology(cls, topo, model, *, buckets, n_replicas: int = 1,
                     device=None, **kw) -> "ServingEngine":
        """Build an engine serving a conv topology (``list[ConvLayer]``)
        through ``models.layers.TrimCNN``.

        ``model`` is a ``TrimCNN`` or its parameter tree (tensors or numpy
        arrays, e.g. ``convert.params_from_jax``), moved to ``device``
        (default ``"cuda"``; raises without a GPU).  Each replica takes a
        numpy batch, runs it on the device under ``torch.inference_mode``
        and returns numpy.  ``n_replicas`` replicas share the module."""
        topo = list(topo)
        dev = resolve_device(device)
        if not isinstance(model, TrimCNN):
            model = TrimCNN(topo, params_from_jax(model, device=dev))
        model = model.to(dev)

        def fn(batch):
            xb = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
            with torch.inference_mode():
                return model(xb.to(dev)).cpu().numpy()

        replicas = [Replica(name=f"replica{i}", fn=fn)
                    for i in range(n_replicas)]
        first = topo[0]
        return cls(replicas, buckets,
                   input_shape=(first.ifmap, first.ifmap,
                                first.in_channels), **kw)

    # -- request intake -----------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def submit(self, rid: int, x, *, now: float) -> None:
        """Enqueue one request.  Raises :class:`QueueFull` at capacity
        (backpressure: the queue depth is bounded by ``max_queue``,
        always)."""
        with self._lock:
            if len(self._queue) >= self.max_queue:
                raise QueueFull(
                    f"queue at capacity ({self.max_queue}); retry or "
                    "shed upstream")
            self.recorder.enqueue(rid, now)
            self._queue.append((rid, np.asarray(x), now))
            self.recorder.note_queue_depth(len(self._queue))

    def head_enqueue_time(self) -> float | None:
        """Enqueue timestamp of the oldest queued request (None when
        idle) — the earliest instant a batch could form."""
        with self._lock:
            return self._queue[0][2] if self._queue else None

    # -- serving ------------------------------------------------------------

    def _pad_batch(self, xs: list[np.ndarray], bucket: int) -> np.ndarray:
        batch = np.stack(xs)
        if len(xs) < bucket:
            pad = np.full((bucket - len(xs),) + batch.shape[1:],
                          self.pad_fill, batch.dtype)
            batch = np.concatenate([batch, pad])
        return batch

    def _ensure_warm(self, bucket: int) -> None:
        """First service of a non-prewarmed bucket — a cold start (the
        JAX engine tunes here), counted so a run can assert prewarm
        coverage was complete."""
        if bucket in self._warm:
            return
        self.cold_tunes += 1
        self._warm.add(bucket)

    def step(self, *, now: float, replica: int | None = None,
             service_model=None) -> tuple[list[tuple[int, np.ndarray]],
                                          float]:
        """Serve one batch from the queue head.

        Drains up to ``max_bucket`` requests FIFO, executes the padded
        bucket on ``replica`` (or the round-robin next), and returns
        ``([(rid, result_row), ...], service_time_s)``.  With
        ``service_model`` (a ``bucket -> seconds`` callable) the
        returned/recorded service time is injected — the deterministic
        virtual-clock mode; otherwise it is the measured wall time of
        the forward.  An empty queue returns ``([], 0.0)``."""
        with self._lock:
            if not self._queue:
                return [], 0.0
            take = min(len(self._queue), self.grid.max_bucket)
            reqs = [self._queue.popleft() for _ in range(take)]
            if replica is None:
                replica = self._rr % len(self.replicas)
            self._rr += 1
        bucket = self.grid.bucket_for(take)
        self._ensure_warm(bucket)
        rep = self.replicas[replica]
        for rid, _, _ in reqs:
            self.recorder.batch(rid, now, bucket=bucket, replica=rep.name,
                                batch_real=take)
            self.recorder.execute(rid, now)
        batch = self._pad_batch([x for _, x, _ in reqs], bucket)
        t0 = time.perf_counter()
        out = np.asarray(rep.fn(batch))
        measured = time.perf_counter() - t0
        dt = float(service_model(bucket)) if service_model else measured
        done = now + dt
        results = []
        for i, (rid, _, _) in enumerate(reqs):
            self.recorder.complete(rid, done)
            results.append((rid, out[i]))
        with self._lock:
            self.served += take
            self._bucket_counts[bucket] = \
                self._bucket_counts.get(bucket, 0) + 1
            self._replica_served[rep.name] += take
        return results, dt

    def forward_one(self, x) -> np.ndarray:
        """The single-request forward (bucket 1 on replica 0) —
        the differential oracle every served row must bit-match."""
        batch = self._pad_batch([np.asarray(x)], self.grid.bucket_for(1))
        return np.asarray(self.replicas[0].fn(batch))[0]

    # -- prewarm ------------------------------------------------------------

    def prewarm(self) -> dict:
        """Make every (bucket, replica) path hot before the first
        request: one throwaway forward per bucket per replica, which
        builds the kernels on first use.  Returns the seconds of each
        bucket's first forward (``{bucket: seconds}``)."""
        seconds: dict = {}
        if self.input_shape is not None:
            for b in self.grid.buckets:
                zeros = np.zeros((b,) + self.input_shape, np.float32)
                t0 = time.perf_counter()
                for rep in self.replicas:
                    rep.fn(zeros)
                seconds[b] = time.perf_counter() - t0
        self._warm.update(self.grid.buckets)
        return seconds

    # -- reporting ----------------------------------------------------------

    def stats(self) -> dict:
        """Serving counters + the per-replica report, with the JAX
        engine's keys; nothing demotes, so ``guard_events`` stay empty."""
        with self._lock:
            per_replica = {
                name: {"served": self._replica_served[name],
                       "degraded": False, "guard_events": []}
                for name in self._replica_served}
            return {
                "served": self.served,
                "pending": len(self._queue),
                "cold_tunes": self.cold_tunes,
                "prewarmed_buckets": sorted(self._warm),
                "bucket_batches": dict(sorted(
                    self._bucket_counts.items())),
                "max_queue_depth": self.recorder.max_queue_depth,
                "rejected": len(self.recorder.rejected),
                "replicas": per_replica,
            }


# ---------------------------------------------------------------------------
# Deterministic open-loop replay
# ---------------------------------------------------------------------------

def replay(engine: ServingEngine, trace, *, service_model=None,
           start: float = 0.0):
    """Event-driven replay of an arrival trace against the engine.

    ``trace`` is an iterable of ``(t_arrival, rid, x)``; arrivals are
    open-loop (they ignore service progress, like real traffic).  The
    loop advances a virtual timeline: a batch starts at
    ``max(earliest free replica, head-of-queue arrival)``, and every
    request arriving at or before that instant joins the queue first —
    continuous batching, replicas kept busy whenever work is queued.
    Arrivals that hit a full queue are rejected (recorded, not raised:
    open-loop load sheds at the backpressure bound).

    With ``service_model`` (``bucket -> seconds``) the whole timeline is
    deterministic — same trace, same results, same timestamps; without
    it, service times are the measured wall time of each real forward
    (the benchmark mode: real kernels under a deterministic arrival
    pattern).

    Returns ``(results, rejected)``: ``{rid: output_row}`` for every
    served request and the rid list of shed ones.  Lifecycle timestamps
    land in ``engine.recorder``.
    """
    trace = sorted(trace, key=lambda e: e[0])
    free = [float(start)] * len(engine.replicas)
    results: dict[int, np.ndarray] = {}
    rejected: list[int] = []
    i, n = 0, len(trace)

    def admit(j: int) -> None:
        t, rid, x = trace[j]
        try:
            engine.submit(rid, x, now=t)
        except QueueFull:
            engine.recorder.reject(rid, t)
            rejected.append(rid)

    while i < n or engine.pending():
        if engine.pending() == 0:
            admit(i)
            i += 1
            continue
        r = int(np.argmin(free))
        t_start = max(free[r], engine.head_enqueue_time())
        # continuous batching: arrivals landing before this batch can
        # start join it (queue permitting)
        while i < n and trace[i][0] <= t_start:
            admit(i)
            i += 1
        out, dt = engine.step(now=t_start, replica=r,
                              service_model=service_model)
        free[r] = t_start + dt
        for rid, y in out:
            results[rid] = y
    return results, rejected
