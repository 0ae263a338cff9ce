"""Async conv serving front end — the production shell around
``core.serving.ServingEngine`` (the counterpart of
``repro/launch/serve_conv.py``; DESIGN.md §10).

The engine itself is a deterministic state machine; this module gives it
the asyncio shell real traffic needs: ``submit`` returns an awaitable
per request, a background batcher task drains the queue into bucket
batches (waiting up to ``max_wait_s`` for a partial batch to fill —
the latency/throughput knob of continuous batching), and forwards run
in a worker thread so the event loop keeps accepting requests while a
batch executes.

The CLI drives the whole serving path once, end to end: build a
topology with seeded random weights, prewarm every bucket (the autotune
sweep of every layer at every bucket, then one forward a bucket, which
builds the CUDA kernels), replay a seeded Poisson arrival trace as real
asyncio clients, and report latency percentiles and throughput.  Full-width
VGG-16 and AlexNet (conv1 11 x 11: the kernel tiling's 16 sub-kernels)
on the card:

  PYTHONPATH=src python -m repro_torch.launch.serve_conv --net vgg16 \
      --scale 1 --requests 32 --buckets 1,2,4,8 --rate 200
  PYTHONPATH=src python -m repro_torch.launch.serve_conv --net alexnet \
      --scale 1 --requests 32 --buckets 1,2,4,8
  PYTHONPATH=src python -m repro_torch.launch.serve_conv --smoke \
      --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_conv --smoke --fused \
      --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import itertools
import time

import numpy as np

from repro_torch.core.serving import QueueFull, ServingEngine


class AsyncConvServer:
    """Asyncio shell over a :class:`ServingEngine`.

    ``await submit(x)`` resolves to the request's output row once its
    batch completes.  A single batcher task serializes ``engine.step``
    calls (replica dispatch stays round-robin inside the engine); the
    forward runs in the default executor so the loop stays responsive.
    ``max_wait_s`` bounds how long a partial batch waits for company —
    0 serves immediately (latency-optimal), larger values trade p50 for
    bigger buckets (throughput-optimal).
    """

    def __init__(self, engine: ServingEngine, *, max_wait_s: float = 0.002,
                 clock=time.monotonic) -> None:
        self.engine = engine
        self.max_wait_s = float(max_wait_s)
        self.clock = clock
        self._rids = itertools.count()
        self._futures: dict[int, asyncio.Future] = {}
        self._wake = asyncio.Event()
        self._task: asyncio.Task | None = None
        self._closing = False

    async def __aenter__(self) -> "AsyncConvServer":
        self._task = asyncio.get_running_loop().create_task(self._serve())
        return self

    async def __aexit__(self, *exc) -> None:
        await self.drain()
        self._closing = True
        self._wake.set()
        await self._task

    async def submit(self, x) -> np.ndarray:
        """Enqueue one request and await its result row.  Raises
        :class:`QueueFull` immediately when the engine queue is at
        capacity — backpressure reaches the client as an exception, not
        an unbounded buffer."""
        rid = next(self._rids)
        fut = asyncio.get_running_loop().create_future()
        try:
            self.engine.submit(rid, x, now=self.clock())
        except QueueFull:
            self.engine.recorder.reject(rid, self.clock())
            raise
        self._futures[rid] = fut
        self._wake.set()
        return await fut

    async def drain(self) -> None:
        """Wait until every accepted request has completed."""
        while self._futures or self.engine.pending():
            await asyncio.sleep(0)
            if self._futures:
                await asyncio.wait(list(self._futures.values()),
                                   timeout=0.05)

    async def _serve(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            if self.engine.pending() == 0:
                if self._closing:
                    return
                await self._wake.wait()
                self._wake.clear()
                continue
            # let a partial batch fill: yield to the loop briefly when
            # the queue has not reached the largest bucket yet
            if (self.max_wait_s > 0
                    and self.engine.pending() < self.engine.grid.max_bucket):
                await asyncio.sleep(self.max_wait_s)
            out, _ = await loop.run_in_executor(
                None, lambda: self.engine.step(now=self.clock()))
            for rid, row in out:
                fut = self._futures.pop(rid, None)
                if fut is not None and not fut.done():
                    fut.set_result(row)


# ---------------------------------------------------------------------------
# CLI driver
# ---------------------------------------------------------------------------

def _build_engine(args):
    from repro_torch.core.fuse_plan import FusedGroupPlan
    from repro_torch.core.model import ConvLayer
    from repro_torch.core.netplan import network_layers, scale_layers
    from repro_torch.models.layers import TrimCNN

    if args.net:
        topo = scale_layers(network_layers(args.net), args.scale)
    else:                       # smoke topology: small, fast, 3 layers
        topo = [ConvLayer("s0", ifmap=16, in_channels=3, out_channels=8,
                          kernel=3, stride=1, padding=1),
                ConvLayer("s1", ifmap=16, in_channels=8, out_channels=8,
                          kernel=3, stride=2, padding=1),
                ConvLayer("s2", ifmap=8, in_channels=8, out_channels=16,
                          kernel=3, stride=1, padding=1)]
    model = TrimCNN.random(topo, n_classes=args.classes, seed=args.seed,
                           device=args.device, dataflow=args.dataflow)
    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = ServingEngine.for_topology(
        topo, model, buckets=buckets, n_replicas=args.replicas,
        device=args.device, fused=args.fused, max_queue=args.max_queue)
    t0 = time.perf_counter()
    recs = engine.prewarm()
    n_tuned = sum(len(r["layers"]) for r in recs.values())
    print(f"prewarm: {len(buckets)} buckets x {len(topo)} layers "
          f"({n_tuned} tune records"
          f"{', fused groups seeded' if args.fused else ''}) + "
          f"{len(buckets) * args.replicas} first forwards in "
          f"{time.perf_counter() - t0:.2f}s — no request hits a cold "
          "tune or a kernel build")
    if args.fused:
        for b in engine.grid.buckets:
            print(f"  fused groups at batch {b}: "
                  f"{FusedGroupPlan.build(topo, n=b).describe()}")
    return engine, topo


async def _run(args) -> None:
    from repro_torch.testing.load import poisson_arrivals

    engine, topo = _build_engine(args)
    shape = (topo[0].ifmap, topo[0].ifmap, topo[0].in_channels)
    rng = np.random.default_rng(args.seed)
    xs = rng.standard_normal((args.requests,) + shape).astype(np.float32)
    arrivals = poisson_arrivals(args.rate, args.requests, seed=args.seed)

    async with AsyncConvServer(engine,
                               max_wait_s=args.max_wait_ms / 1e3) as srv:
        t0 = time.monotonic()

        async def client(i: int):
            await asyncio.sleep(max(0.0, t0 + arrivals[i]
                                    - time.monotonic()))
            try:
                return await srv.submit(xs[i])
            except QueueFull:
                return None

        outs = await asyncio.gather(*[client(i)
                                      for i in range(args.requests)])

    served = [o for o in outs if o is not None]
    s = engine.recorder.summary()
    st = engine.stats()
    print(f"served {len(served)}/{args.requests} "
          f"(rejected {st['rejected']}) at "
          f"{s.get('throughput_rps', 0.0):.1f} req/s — "
          f"p50 {s.get('p50_s', 0.0) * 1e3:.2f}ms "
          f"p99 {s.get('p99_s', 0.0) * 1e3:.2f}ms; "
          f"bucket batches {st['bucket_batches']}; "
          f"cold tunes {st['cold_tunes']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--net", default=None,
                    choices=["vgg16", "alexnet", "mobilenet"],
                    help="serve a scaled paper topology (default: a "
                         "small smoke CNN)")
    ap.add_argument("--scale", type=int, default=32,
                    help="channel divisor for --net")
    ap.add_argument("--dataflow", default=None, choices=["carry", "halo"],
                    help="conv kernel dataflow (default: carry)")
    ap.add_argument("--fused", action="store_true",
                    help="serve fused residency groups (conv->[pool]->conv "
                         "chains in one launch; DESIGN.md §8)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "plain PyTorch versions)")
    ap.add_argument("--buckets", default="1,2,4",
                    help="comma-separated batch bucket grid")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel serving replicas")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate (req/s)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--max-queue", type=int, default=256)
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="how long a partial batch waits to fill")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny end-to-end run (CI)")
    args = ap.parse_args(argv)
    if args.fused and args.dataflow == "halo":
        ap.error("--fused runs the fused kernel and the carry kernel; "
                 "it does not take --dataflow halo")
    if args.smoke:
        args.net, args.requests = None, min(args.requests, 8)
        args.rate = min(args.rate, 500.0)
    asyncio.run(_run(args))


if __name__ == "__main__":
    main()
