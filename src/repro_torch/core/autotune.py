"""Per-layer conv autotuner for the H100 with a persistent JSON cache (the
counterpart of ``repro/core/autotune.py``; DESIGN.md §4).

The search space is :class:`~repro_torch.core.conv_plan.ConvPlan`'s knobs
— ``tile_h`` (the strip), ``tile_cout`` (the C_out tile) and
``dataflow`` — and :class:`~repro_torch.core.conv_plan.WeightGradPlan`'s
``tile_go`` (the chunk height); the fused groups' knob is
:class:`~repro_torch.core.fuse_plan.FusedGroup`'s ``strip_rows`` x
``band_cols`` tile.  Candidates are ranked by the planner's own objective
(:func:`_model_score`), so the model's winner is the plan ``ConvPlan``
picks with no knobs; ``measure=True`` times the leaders on the tensors'
device and the fastest wins.  The winner is persisted in a JSON cache that
``ops.conv2d`` (and its int8 route, its backward, packed weights and
``FusedGroupPlan.build(use_autotune_cache=True)``) consults.

The cache is the port's own: ``$REPRO_TORCH_CONVTUNE_CACHE`` if set,
else ``~/.cache/repro_torch/convtune.json``; ``REPRO_TORCH_CONV_AUTOTUNE=0``
turns every lookup off.  The JAX package's cache is never read: its knobs
size a TPU VMEM tile, these a Hopper strip and C_out tile.  Schema
(version 1)::

    {"version": 1,
     "entries": {"<key>": {"tile_h": int|null, "tile_cout": int,
                           "dataflow": "carry"|"halo",
                           "source": "model"|"measured",
                           "model_key": [...], "measured_us": float|null,
                           "tile_w": int, "segments": int, "blocks": int}}}

``tile_h`` null is the planner's strip for the record's C_out tile and
dataflow (the int8 planner picks the strip and the warp layout together,
so its strip is not a knob that replays on its own).  A ``bfloat16``
record also holds the layer's bf16 route (``"route": "mma"|"ffma"``,
``conv_plan.bf16_route``), a fused one its stages' (``"routes"``); a
record without it predates the tensor-core route (it was tuned for the
fmaf chain, route ``"ffma"``) and is read only where the route is still
``"ffma"``: it is never replayed as an ``mma`` plan.  Likewise a
``bfloat16`` ``conv2d_wgrad:`` record holds the layer's weight-gradient
route (``"route": "mma"|"gemm"|"depthwise"``, ``conv_plan.wgrad_route``);
one without it was tuned for the widened FFMA kernel and is never read on
a layer of route ``"mma"``.

Keys are ``<op>:n..h..w..cin..cout..k<kh>x<kw>s..p<t>.<b>.<l>.<r>g..:
<dtype>:<backend>``: the problem as the port's kernel sees it — the
unpadded input and the virtual pads ``((top, bottom), (left, right))``
that ``ConvPlan.build`` takes (the JAX key holds the pre-padded shape; the
port pads inside the loader).  ``<backend>`` is the device the tensors
live on: ``cpu``, or a CUDA card's compute capability and name
(``cuda:sm90:NVIDIA_H100_80GB_HBM3``), so a record tuned on one card never
feeds another card or the CPU.  The namespaces ``conv2d:`` (the forward,
and the input-gradient conv over its own problem), ``conv2d_q8:`` (the
int8 route), ``conv2d_wgrad:`` and ``conv2d_fused:`` never alias.

Robustness (DESIGN.md §9), as in JAX: ``store`` takes a ``.lock`` sidecar
file lock and re-reads + merges the on-disk entries before an atomic
``os.replace``, so concurrent processes never drop each other's records;
an unreadable or wrong-version file is quarantined (renamed to
``convtune.json.corrupt-<pid>`` with a warning), never silently reset; a
record is validated structurally and against the current problem
(``ConvPlan.build`` / ``WeightGradPlan.build`` must accept its knobs, the
port's counterpart of JAX's VMEM check), and a bad one is a miss, warned
once per (path, key).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import time
import warnings

import numpy as np
import torch

from repro_torch.core import conv_plan
from repro_torch.core.conv_plan import (BF16_TILE_COUTS, CONV_MAX_TILE_COUT,
                                        DATAFLOWS, Q8_TILE_COUTS,
                                        SMEM_PER_BLOCK, SMS, ConvPlan,
                                        WeightGradPlan, _wgrad_min_rows,
                                        bf16_route, input_grad_geometry,
                                        mma_strip_clocks, normalize_pad)
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import conv_pads

try:
    import fcntl
except ImportError:          # non-POSIX: cooperative locking unavailable
    fcntl = None

CACHE_ENV = "REPRO_TORCH_CONVTUNE_CACHE"
AUTOTUNE_ENV = "REPRO_TORCH_CONV_AUTOTUNE"   # "0" disables every lookup
DTYPE_BYTES = {name: b for b, name in conv_plan.DTYPE_BYTES.items()}
_SCHEMA_VERSION = 1

# path -> entries; a missing file is memoized as {} so the lookup on every
# ops.conv2d call costs one dict probe, not a stat
_MEM: dict[str, dict] = {}
# (path, key) pairs already warned about: one warning per bad record
_WARNED: set = set()
# (path, key) -> the validated record or None: a consult on a conv call
# validates a record once, not on every call
_CHECKED: dict = {}
# patchable alias: a test swaps it to simulate a crash before the publish
_publish = os.replace


# ---------------------------------------------------------------------------
# Cache file
# ---------------------------------------------------------------------------

def cache_path(path: str | None = None) -> str:
    """The cache file: explicit arg > ``$REPRO_TORCH_CONVTUNE_CACHE`` >
    ``~/.cache/repro_torch/convtune.json``."""
    if path:
        return path
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "convtune.json")


def reset_memory_cache() -> None:
    """Drop the in-process memo (tests; after another process wrote)."""
    _MEM.clear()
    _WARNED.clear()
    _CHECKED.clear()


def _quarantine(path: str, reason: str) -> None:
    """Move an unusable cache file aside (never silently discard it)."""
    dest = f"{path}.corrupt-{os.getpid()}"
    try:
        os.replace(path, dest)
    except OSError:
        dest = "<unmovable>"
    warnings.warn(
        f"autotune cache {path} is unusable ({reason}); quarantined to "
        f"{dest} and starting a fresh cache", RuntimeWarning, stacklevel=3)


def _read_disk(path: str) -> dict:
    """Fresh read of the on-disk entries.  A missing file is an empty
    cache; corrupt JSON, a non-dict document, an empty file or a
    ``version`` other than ours is quarantined (version 1 is the first
    schema: there is nothing to migrate from)."""
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        _quarantine(path, f"unreadable: {type(e).__name__}: {e}")
        return {}
    if not isinstance(data, dict) or not isinstance(
            data.get("entries", {}), dict):
        _quarantine(path, "not a cache document")
        return {}
    version = data.get("version")
    if version != _SCHEMA_VERSION:
        _quarantine(path, f"schema version {version!r} != "
                          f"{_SCHEMA_VERSION} (no migration path)")
        return {}
    return dict(data.get("entries", {}))


def _entries(path: str) -> dict:
    if path not in _MEM:
        _MEM[path] = _read_disk(path)
    return _MEM[path]


@contextlib.contextmanager
def _locked(path: str):
    """Hold the cache's ``.lock`` sidecar (blocking flock) over the
    read-merge-replace of :func:`store`.  The sidecar, not the cache file,
    carries the lock, so the atomic replace never invalidates a held
    descriptor."""
    if fcntl is None:
        yield
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lk, fcntl.LOCK_UN)


def lookup(key: str, path: str | None = None) -> dict | None:
    """The cached record for ``key``, or None."""
    return _entries(cache_path(path)).get(key)


def store(key: str, record: dict, path: str | None = None) -> str:
    """Insert or overwrite one record and persist the cache atomically:
    under the lock, re-read the disk and merge it over the memo (disk wins
    per key: no lost updates), apply the record, write a temp file and
    publish it with an atomic rename."""
    path = cache_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with _locked(path):
        merged = {**_MEM.get(path, {}), **_read_disk(path)}
        merged[key] = dict(record)
        _MEM[path] = merged
        for tag in [t for t in _CHECKED if t[0] == path]:
            del _CHECKED[tag]
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump({"version": _SCHEMA_VERSION, "entries": merged}, f,
                      indent=1, sort_keys=True)
        try:
            _publish(tmp, path)
        except BaseException:
            # a crash before the publish must not leave the temp file
            # looking like a cache
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
    return path


# ---------------------------------------------------------------------------
# Keys and validation
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _cuda_backend(index: int) -> str:
    major, minor = torch.cuda.get_device_capability(index)
    name = "_".join(torch.cuda.get_device_name(index).split())
    return f"cuda:sm{major}{minor}:{name}"


def backend(device=None) -> str:
    """The key's backend for tensors on ``device`` (``None``: ``"cuda"``,
    raising without a GPU): ``"cpu"``, or ``cuda:sm<cc>:<card name>``."""
    dev = device if isinstance(device, torch.device) \
        and device.type in ("cpu", "cuda") else resolve_device(device)
    if dev.type == "cpu":
        return "cpu"
    index = dev.index if dev.index is not None \
        else torch.cuda.current_device()
    return _cuda_backend(index)


def dtype_name(dtype: torch.dtype) -> str:
    """The dtype field of a key: ``torch.bfloat16`` -> ``"bfloat16"``, as
    the JAX key's ``str(x.dtype)``."""
    return str(dtype).removeprefix("torch.")


def _dtype_bytes(dtype: str) -> int:
    if dtype not in DTYPE_BYTES:
        raise ValueError(f"dtype={dtype!r}: the port's conv kernels take "
                         f"{sorted(DTYPE_BYTES)}")
    return DTYPE_BYTES[dtype]


def make_key(x_shape, w_shape, *, stride: int = 1, pad=0, groups: int = 1,
             dtype: str = "float32", device=None,
             op: str = "conv2d") -> str:
    """Cache key of one conv problem: ``x_shape`` the unpadded input the
    kernel reads, ``pad`` its virtual padding (an int or ``((top,
    bottom), (left, right))``).  ``op`` names the namespace: ``"conv2d"``
    for the forward (and the input-gradient conv, a forward problem over
    its own shapes), ``"conv2d_q8"`` for the int8 route,
    ``"conv2d_wgrad"`` for the weight gradient.  ``ops.conv2d`` and
    :func:`tune_network` both key through here."""
    return _key(tuple(x_shape), tuple(w_shape), stride, normalize_pad(pad),
                groups, dtype, backend(device), op)


@functools.lru_cache(maxsize=4096)
def _key(x_shape, w_shape, stride, pad, groups, dtype, bk, op) -> str:
    n, h, w, cin = (int(v) for v in x_shape)
    kh, kw, _, cout = (int(v) for v in w_shape)
    (pt, pb), (pl, pr) = pad
    return (f"{op}:n{n}h{h}w{w}cin{cin}cout{cout}k{kh}x{kw}s{int(stride)}"
            f"p{pt}.{pb}.{pl}.{pr}g{int(groups)}:{dtype}:{bk}")


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _valid_record(rec, stride: int) -> bool:
    return (isinstance(rec, dict)
            and "tile_h" in rec
            and (rec["tile_h"] is None
                 or (_is_int(rec["tile_h"]) and rec["tile_h"] >= stride
                     and rec["tile_h"] % stride == 0))
            and _is_int(rec.get("tile_cout")) and rec["tile_cout"] >= 1
            and rec.get("dataflow") in DATAFLOWS)


def _reject(key: str, reason: str, path: str | None) -> None:
    """A bad record is a miss; warn once per (path, key) so that it shows
    without a warning on every conv call."""
    tag = (cache_path(path), key)
    if tag in _WARNED:
        return
    _WARNED.add(tag)
    warnings.warn(
        f"ignoring malformed autotune record {key!r}: {reason} "
        "(treated as a cache miss; delete or re-tune the entry)",
        RuntimeWarning, stacklevel=3)


def _disabled() -> bool:
    return os.environ.get(AUTOTUNE_ENV, "1") == "0"


def knobs_for(x_shape, w_shape, *, stride: int = 1, pad=0, groups: int = 1,
              dtype: str = "float32", device=None, op: str = "conv2d",
              path: str | None = None) -> dict | None:
    """The cached, validated knobs of one problem, or None: the lookup
    ``ops.conv2d`` makes for every knob left ``None``.  Honors
    ``REPRO_TORCH_CONV_AUTOTUNE=0``.  A record whose knobs
    ``ConvPlan.build`` refuses for this problem (or whose plan would not
    fit :data:`SMEM_PER_BLOCK`) is a miss with one warning."""
    if _disabled():
        return None
    key = make_key(x_shape, w_shape, stride=stride, pad=pad, groups=groups,
                   dtype=dtype, device=device, op=op)
    tag = (cache_path(path), key)
    if tag not in _CHECKED:
        _CHECKED[tag] = _checked_record(key, x_shape, w_shape, stride, pad,
                                        groups, dtype, path)
    return _CHECKED[tag]


def _checked_record(key, x_shape, w_shape, stride, pad, groups, dtype,
                    path) -> dict | None:
    rec = lookup(key, path)
    if rec is None:
        return None
    if not _valid_record(rec, stride):
        _reject(key, f"bad shape/type/knobs: {rec!r}", path)
        return None
    if dtype == "bfloat16":
        route = bf16_route(int(w_shape[2]), groups)
        if rec.get("route", "ffma") != route:
            _reject(key, f"a record of bf16 route {rec.get('route', 'ffma')!r}"
                         f" for a layer on route {route!r}", path)
            return None
    try:
        plan = ConvPlan.build(x_shape, w_shape, stride=stride, pad=pad,
                              groups=groups, tile_h=rec["tile_h"],
                              tile_cout=rec["tile_cout"],
                              dataflow=rec["dataflow"],
                              dtype_bytes=_dtype_bytes(dtype))
        if plan.smem_bytes > SMEM_PER_BLOCK:
            raise ValueError(f"shared memory {plan.smem_bytes} > "
                             f"{SMEM_PER_BLOCK}")
    except ValueError as e:
        _reject(key, f"knobs infeasible for current geometry: {e}", path)
        return None
    return rec


def _valid_wgrad_record(rec) -> bool:
    return (isinstance(rec, dict) and _is_int(rec.get("tile_go"))
            and rec["tile_go"] >= 1)


def weight_grad_knobs_for(x_shape, w_shape, *, stride: int = 1, pad=0,
                          groups: int = 1, dtype: str = "float32",
                          device=None,
                          path: str | None = None) -> dict | None:
    """The cached, validated weight-gradient knob (``tile_go``) of one
    forward problem, or None: the lookup the conv backward makes.  Honors
    ``REPRO_TORCH_CONV_AUTOTUNE=0``."""
    if _disabled():
        return None
    key = make_key(x_shape, w_shape, stride=stride, pad=pad, groups=groups,
                   dtype=dtype, device=device, op="conv2d_wgrad")
    tag = (cache_path(path), key)
    if tag not in _CHECKED:
        _CHECKED[tag] = _checked_wgrad_record(key, x_shape, w_shape, stride,
                                              pad, groups, dtype, path)
    return _CHECKED[tag]


def _checked_wgrad_record(key, x_shape, w_shape, stride, pad, groups,
                          dtype, path) -> dict | None:
    rec = lookup(key, path)
    if rec is None:
        return None
    if not _valid_wgrad_record(rec):
        _reject(key, f"bad shape/type/knobs: {rec!r}", path)
        return None
    try:
        plan = WeightGradPlan.build(x_shape, w_shape, stride=stride, pad=pad,
                                    groups=groups, tile_go=rec["tile_go"],
                                    dtype_bytes=_dtype_bytes(dtype))
    except ValueError as e:
        _reject(key, f"knobs infeasible for current geometry: {e}", path)
        return None
    # a record names its route (bf16), or has none and was tuned for the
    # FFMA kernel, which no layer of route mma runs
    route = rec.get("route")
    if route != plan.route and (route is not None or plan.route == "mma"):
        _reject(key, f"a record of wgrad route {rec.get('route')!r} for a "
                     f"layer on route {plan.route!r}", path)
        return None
    return rec


# ---------------------------------------------------------------------------
# Search
# ---------------------------------------------------------------------------

def candidate_knobs(x_shape, w_shape, *, stride: int = 1, pad=0,
                    groups: int = 1, dtype_bytes: int = 4) -> list:
    """``(knobs, plan)`` pairs over ``(tile_h, tile_cout, dataflow)``, one
    per distinct plan, each one ``ConvPlan.build`` accepts (so each fits
    :data:`SMEM_PER_BLOCK`).  Strip ticks: ``s, 2s, ..., 32s``, the
    default plan's strip, the full height, and ``None`` (the planner's
    strip for the tile); C_out ticks: 32, 64, 128, the default's and
    Cout/g, each at most Cout/g and :data:`CONV_MAX_TILE_COUT`; both
    dataflows.  The default plan (no knobs) comes first."""
    kw = dict(stride=stride, pad=pad, groups=groups, dtype_bytes=dtype_bytes)
    base = ConvPlan.build(x_shape, w_shape, **kw)
    s, full_h = base.stride, base.h_out * base.stride
    h_ticks = sorted({t for t in (s, 2 * s, 4 * s, 8 * s, 16 * s, 32 * s,
                                  base.tile_h, full_h) if t <= full_h})
    top = min(base.cout_per_group, CONV_MAX_TILE_COUT)
    c_ticks = sorted({t for t in (32, 64, 128, base.tile_cout,
                                  base.cout_per_group) if t <= top})
    found = {}
    for dataflow in DATAFLOWS:
        for tc in c_ticks:
            for th in [*h_ticks, None]:
                try:
                    plan = ConvPlan.build(x_shape, w_shape, tile_h=th,
                                          tile_cout=tc, dataflow=dataflow,
                                          **kw)
                except ValueError:
                    continue
                found.setdefault(plan, dict(tile_h=th, tile_cout=tc,
                                            dataflow=dataflow))
    first = found.pop(base, dict(tile_h=None, tile_cout=base.tile_cout,
                                 dataflow=base.dataflow))
    return [(first, base)] + [(k, p) for p, k in found.items()]


def _in_planner_space(plan: ConvPlan, base: ConvPlan) -> bool:
    """Whether ``ConvPlan.build``'s own search could return ``plan``: the
    channel pitch it settled on, one of the C_out tiles it tries and, on
    the int8 tensor-core routes, the tallest strip the M tile holds."""
    if plan.cin_stride != base.cin_stride:
        return False
    cpg = plan.cout_per_group
    if plan.tensor_cores:
        tiles = {min(cpg, c) for c in (
            BF16_TILE_COUTS if plan.dtype_bytes == 2 else Q8_TILE_COUTS)}
        natural = min(plan.h_out, plan.slots // plan.tile_w)
        return plan.tile_cout in tiles and plan.th_out == natural
    return plan.tile_cout in {min(cpg, CONV_MAX_TILE_COUT),
                              min(cpg, CONV_MAX_TILE_COUT // 2)}


def _model_score(plan: ConvPlan, base: ConvPlan) -> tuple:
    """Deterministic ranking key: the port planner's own objective, so
    that the default plan ranks first.

    A plan outside the planner's search (:func:`_in_planner_space`: a
    narrower C_out tile, the other channel pitch, a short int8 strip)
    ranks after every plan inside it: the objective does not price what
    it costs (a narrow tile re-reads the window once a tile; the plain
    pitch's bank conflicts), so only measurement can promote it.  Then
    the objective of the tile, evaluated on its carry schedule: f32 (and
    the int8 dp4a route) the busiest SM's strips, then the window pixels
    read per output (``_best_tile``); the int8 tensor-core routes whether
    the blocks fill the SMs, then the clocks of the latency model
    (``mma_strip_clocks``), then the window pixels per output element
    (``_build_q8``; the bf16 mma route's ``_build_bf16_mma`` alike); then
    the planner's tie-breaks (wider band, larger
    C_out tile, shorter strip).  Then the plan's own HBM bytes (carry
    re-reads fewer rows than halo), then fewer blocks, then carry.  Unlike
    JAX, no tie goes to halo: the TPU grid's parallel axes argue for it,
    the card's launch does not; a measured tune decides."""
    c = plan if plan.dataflow == "carry" \
        else dataclasses.replace(plan, dataflow="carry")
    if plan.tensor_cores:
        head = (c.blocks < SMS,
                c.rounds * c.strips_per_segment * mma_strip_clocks(c),
                c.window_rows * c.window_cols / (c.positions * c.tile_cout))
    else:
        head = (-(-c.blocks // SMS) * c.strips_per_segment,
                c.window_rows * c.window_cols / c.positions)
    return (not _in_planner_space(plan, base), *head, -c.tile_w,
            -c.tile_cout, c.tile_h, plan.hbm_bytes()["total"], plan.blocks,
            plan.dataflow != "carry")


def _as_record(knobs: dict, plan: ConvPlan, score: tuple, *, source: str,
               measured_us: float | None = None) -> dict:
    route = {"route": plan.bf16_route} if plan.dtype_bytes == 2 else {}
    return dict(knobs, source=source,
                model_key=[float(v) for v in score],
                measured_us=measured_us, tile_w=plan.tile_w,
                segments=plan.segments, blocks=plan.blocks, **route)


def _operands(xs, ws, device: torch.device, dtype: str):
    """Seeded operands of one problem on ``device``: f32 (or bf16) x and
    w, or (the int8 route, as JAX times it) integer x and w."""
    rng = np.random.default_rng(0)
    if dtype == "int8":
        x = rng.integers(-128, 128, xs, dtype=np.int8)
        w = rng.integers(-128, 128, ws, dtype=np.int8)
    else:
        x = rng.standard_normal(xs, dtype=np.float32)
        w = (rng.standard_normal(ws, dtype=np.float32) * 0.1) \
            .astype(np.float32)
    x, w = torch.from_numpy(x).to(device), torch.from_numpy(w).to(device)
    if dtype == "bfloat16":
        return x.bfloat16(), w.bfloat16()
    return x, w


def _measure_plan(x_shape, w_shape, knobs, *, stride: int, pad,
                  groups: int, dtype: str, device: torch.device,
                  reps: int = 10, turns: int = 5) -> list:
    """Microseconds a call of each candidate plan's kernel on ``device``,
    the plans given by ``knobs`` (dicts of ``tile_h``, ``tile_cout``,
    ``dataflow``: the knobs that replay to them), the median of ``turns``
    rounds that time every candidate in turn.  On a CUDA device each runs
    ``reps`` launches captured in one CUDA graph, timed with CUDA events
    (small launches are shorter than the wrapper's host time); on a CPU
    tensor the wrapper runs its plain version, timed on the host clock
    (the tests' counterpart of JAX's interpret mode)."""
    from repro_torch.kernels.trim_conv2d import (pack_q8_weights,
                                                 trim_conv2d,
                                                 trim_conv2d_q8)
    x, w = _operands(x_shape, w_shape, device, dtype)
    if dtype == "int8":
        wp = pack_q8_weights(w) if device.type == "cuda" else None
        scale = torch.ones((w.shape[3],), dtype=torch.float32,
                           device=device)

        def call(k):
            return trim_conv2d_q8(x, w, None, scale, stride=stride, pad=pad,
                                  groups=groups, w_packed=wp, **k)
    else:
        def call(k):
            return trim_conv2d(x, w, None, stride=stride, pad=pad,
                               groups=groups, **k)
    times = [[] for _ in knobs]
    if device.type != "cuda":
        for k in knobs:
            call(k)
        for _ in range(turns):
            for i, k in enumerate(knobs):
                t0 = time.perf_counter()
                call(k)
                times[i].append((time.perf_counter() - t0) * 1e6)
        return [float(np.median(t)) for t in times]
    with torch.cuda.device(device):
        graphs = []
        for k in knobs:
            call(k)                       # builds the library, warms up
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                call(k)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(reps):
                    call(k)
            graph.replay()
            graphs.append(graph)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        for _ in range(turns):
            for i, graph in enumerate(graphs):
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                times[i].append(start.elapsed_time(end) * 1e3 / reps)
        del graphs
    return [float(np.median(t)) for t in times]


def _default_op(op: str | None, dtype: str) -> str:
    if op is not None:
        return op
    return "conv2d_q8" if dtype == "int8" else "conv2d"


def tune(x_shape, w_shape, *, stride: int = 1, pad=0, groups: int = 1,
         dtype: str = "float32", device=None, op: str | None = None,
         measure: bool = False, measure_top_k: int = 4, write: bool = True,
         path: str | None = None) -> dict:
    """Tune one conv problem and (by default) persist the winner.

    Candidates (:func:`candidate_knobs`) are ranked by
    :func:`_model_score`; the model's winner is the default plan.  With
    ``measure=True`` the ``measure_top_k`` leaders (the default always
    among them) are timed on ``device`` (:func:`_measure_plan`; default
    ``"cuda"``, raising without a GPU) and the fastest wins.  ``dtype``
    ``"int8"`` tunes the int8 kernel under ``conv2d_q8:`` (``op`` None
    picks the namespace from the dtype).  Returns the record."""
    dev = resolve_device(device)
    op = _default_op(op, dtype)
    cands = candidate_knobs(x_shape, w_shape, stride=stride, pad=pad,
                            groups=groups, dtype_bytes=_dtype_bytes(dtype))
    base = cands[0][1]
    ranked = sorted(((_model_score(p, base), k, p) for k, p in cands),
                    key=lambda c: c[0])
    if measure:
        leaders = ranked[:max(1, measure_top_k)]
        if all(p != base for _, _, p in leaders):
            leaders[-1] = next(c for c in ranked if c[2] == base)
        us = _measure_plan(x_shape, w_shape, [k for _, k, _ in leaders],
                           stride=stride, pad=pad, groups=groups,
                           dtype=dtype, device=dev)
        t, _, (score, knobs, plan) = min(
            (u, i, c) for i, (u, c) in enumerate(zip(us, leaders)))
        record = _as_record(knobs, plan, score, source="measured",
                            measured_us=t)
    else:
        score, knobs, plan = ranked[0]
        record = _as_record(knobs, plan, score, source="model")
    if write:
        store(make_key(x_shape, w_shape, stride=stride, pad=pad,
                       groups=groups, dtype=dtype, device=dev, op=op),
              record, path)
    return record


# ---------------------------------------------------------------------------
# Backward shapes (DESIGN.md §5)
# ---------------------------------------------------------------------------

def candidate_weight_grad_knobs(x_shape, w_shape, *, stride: int = 1,
                                pad=0, groups: int = 1,
                                dtype_bytes: int = 4) -> list:
    """Distinct :class:`WeightGradPlan` candidates over ``tile_go``: the
    cotangent-row ticks 1, 2, ..., 32, the default's and all rows (each
    raised to the workspace cap by the plan), the default first."""
    kw = dict(stride=stride, pad=pad, groups=groups, dtype_bytes=dtype_bytes)
    base = WeightGradPlan.build(x_shape, w_shape, **kw)
    rows = base.n * base.h_out
    plans = {base: None}
    for t in (1, 2, 4, 8, 16, 32, base.tile_go, rows):
        if t <= rows:
            plans.setdefault(WeightGradPlan.build(x_shape, w_shape,
                                                  tile_go=t, **kw))
    return list(plans)


def _wgrad_score(p: WeightGradPlan, base: WeightGradPlan) -> tuple:
    """``WeightGradPlan``'s own ranking.  GEMM routes: chunks of fewer
    than its minimum rows last, then the plan's time model
    (``WeightGradPlan.model_seconds``: whole rounds of resident blocks at
    the route's rate, 67 TFLOP/s of FFMA or 989 of the bf16 tensor cores,
    plus the workspace's traffic at 3.35 TB/s), ties to the taller chunk.
    Depthwise route: the plan's block-count rule (the default) first,
    then taller chunks."""
    if p.route == "depthwise":
        return (p.tile_go != base.tile_go, 0.0, -p.tile_go)
    _, min_rows = _wgrad_min_rows(p.n * p.h_out, p.w_out, p.dw_elems)
    return (p.tile_go < min_rows, p.model_seconds(), -p.tile_go)


def tune_weight_grad(x_shape, w_shape, *, stride: int = 1, pad=0,
                     groups: int = 1, dtype: str = "float32", device=None,
                     write: bool = True, path: str | None = None) -> dict:
    """Tune the weight-gradient kernel of one forward problem by
    :func:`_wgrad_score` (model only, as in JAX) and (by default) persist
    it under ``conv2d_wgrad:`` at ``dtype``.  A bf16 record names the
    layer's route (``"route"``): on route mma the candidates are the bf16
    tensor-core plans, ranked at their own rate; on routes gemm and
    depthwise the bf16 entry runs the f32 geometry, so both dtypes rank
    the same plans (each keeps its own record, as the backward looks them
    up at the tensors' dtype)."""
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"the weight-gradient kernel takes float32 or "
                         f"bfloat16, got {dtype!r}")
    dev = resolve_device(device)
    plans = candidate_weight_grad_knobs(x_shape, w_shape, stride=stride,
                                        pad=pad, groups=groups,
                                        dtype_bytes=_dtype_bytes(dtype))
    best = min(plans, key=lambda p: _wgrad_score(p, plans[0]))
    record = dict(tile_go=best.tile_go, source="model",
                  model_key=[float(v) for v in _wgrad_score(best,
                                                            plans[0])],
                  measured_us=None, chunks=best.chunks, blocks=best.blocks)
    if dtype == "bfloat16":
        record["route"] = best.route
    if write:
        store(make_key(x_shape, w_shape, stride=stride, pad=pad,
                       groups=groups, dtype=dtype, device=dev,
                       op="conv2d_wgrad"), record, path)
    return record


def tune_backward(x_shape, w_shape, *, stride: int = 1, pad=0,
                  groups: int = 1, dtype: str = "float32", device=None,
                  measure: bool = False, write: bool = True,
                  path: str | None = None) -> dict:
    """Tune both cotangents of one forward problem: the input-gradient
    conv under the ``conv2d:`` key of its own problem (the dilated
    cotangent, the transposed weights, the edge pads of
    :func:`input_grad_geometry`), where the backward looks it up, and the
    weight gradient under ``conv2d_wgrad:``.  Returns ``{"input_grad":
    rec, "weight_grad": rec}``."""
    geo = input_grad_geometry(x_shape, w_shape, stride=stride, pad=pad,
                              groups=groups)
    igrad = tune(geo["g_dilated_shape"], geo["wt_shape"], stride=1,
                 pad=(geo["pad_h"], geo["pad_w"]), groups=groups,
                 dtype=dtype, device=device, op="conv2d", measure=measure,
                 write=write, path=path)
    wgrad = tune_weight_grad(x_shape, w_shape, stride=stride, pad=pad,
                             groups=groups, dtype=dtype, device=device,
                             write=write, path=path)
    return {"input_grad": igrad, "weight_grad": wgrad}


# ---------------------------------------------------------------------------
# Whole-network sweeps (DESIGN.md §7, §10)
# ---------------------------------------------------------------------------

def layer_problem(layer, *, n: int = 1):
    """``(x_shape, pads, w_shape)`` of the conv ``ops.conv2d`` runs for
    one topology layer: the unpadded input and the virtual pads of the
    layer's padding mode (``core.netplan.layer_kernel_problem``, which
    raises for a padding the execution path cannot reproduce)."""
    from repro_torch.core.netplan import layer_kernel_problem
    _, _, w_shape, padding = layer_kernel_problem(layer, n=n)
    pads = conv_pads(layer.ifmap, layer.ifmap, layer.kernel, layer.stride,
                     padding)
    return (n, layer.ifmap, layer.ifmap, layer.in_channels), pads, w_shape


def tune_network(network="vgg16", *, n: int = 1, dtype: str = "float32",
                 device=None, op: str | None = None, measure: bool = False,
                 measure_top_k: int = 4, include_backward: bool = False,
                 write: bool = True, path: str | None = None) -> dict:
    """Tune every conv layer of a topology (a name, "vgg16" | "alexnet" |
    "mobilenet", or a ``list[ConvLayer]``) at batch ``n``, keyed as
    ``ops.conv2d`` looks the layer up (:func:`layer_problem`).  Layers
    that share a key are tuned once; a layer with K >
    ``ops.MAX_NATIVE_K`` runs the kernel tiling's adder tree, which never
    consults the cache, and is recorded as skipped.  ``dtype="int8"``
    seeds the int8 route (``conv2d_q8:``); ``include_backward`` adds both
    cotangent records of each layer (:func:`tune_backward`).

    Returns ``{layer_name: record}``, each with ``record["key"]`` (or
    ``{"skipped": reason}``)."""
    from repro_torch.core.netplan import network_layers
    from repro_torch.kernels.ops import MAX_NATIVE_K
    if include_backward and dtype not in ("float32", "bfloat16"):
        raise ValueError(f"include_backward: the {dtype} route is "
                         "inference only")
    dev = resolve_device(device)
    op = _default_op(op, dtype)
    results: dict[str, dict] = {}
    seen: dict[str, dict] = {}
    for layer in network_layers(network):
        if layer.name in results:
            raise ValueError(f"duplicate layer name {layer.name!r} in "
                             "topology; give repeated blocks unique names")
        if layer.kernel > MAX_NATIVE_K:
            results[layer.name] = {
                "skipped": f"K={layer.kernel} > {MAX_NATIVE_K}: "
                           "kernel-tiled path (no cache)"}
            continue
        x_shape, pads, w_shape = layer_problem(layer, n=n)
        common = dict(stride=layer.stride, pad=pads, groups=layer.groups,
                      dtype=dtype, device=dev, write=write, path=path)
        key = make_key(x_shape, w_shape, stride=layer.stride, pad=pads,
                       groups=layer.groups, dtype=dtype, device=dev, op=op)
        if key not in seen:
            rec = tune(x_shape, w_shape, op=op, measure=measure,
                       measure_top_k=measure_top_k, **common)
            rec = dict(rec, key=key)
            if include_backward:
                rec["backward"] = tune_backward(x_shape, w_shape,
                                                measure=measure, **common)
            seen[key] = rec
        results[layer.name] = seen[key]
    return results


def prewarm_buckets(network, buckets, *, dtype: str = "float32",
                    device=None, op: str | None = None, fused: bool = False,
                    include_backward: bool = False, measure: bool = False,
                    measure_top_k: int = 4, write: bool = True,
                    path: str | None = None) -> dict:
    """Warm the cache across a serving bucket grid (DESIGN.md §10):
    :func:`tune_network` at every bucket, and with ``fused=True``
    :func:`tune_fused_network` too, so no request (whose batch is rounded
    up to a bucket) meets a cold tune.  Buckets are deduplicated and swept
    ascending, so concurrent prewarmers (replicas starting at once) write
    the same records in the same order and merge cleanly.

    Returns ``{bucket: {"layers": ...[, "fused": ...]}}``."""
    results: dict[int, dict] = {}
    for n in sorted({int(b) for b in buckets}):
        if n < 1:
            raise ValueError(f"batch bucket must be >= 1, got {n}")
        per = {"layers": tune_network(
            network, n=n, dtype=dtype, device=device, op=op,
            measure=measure, measure_top_k=measure_top_k,
            include_backward=include_backward, write=write, path=path)}
        if fused:
            per["fused"] = tune_fused_network(
                network, n=n, dtype=dtype, device=device, write=write,
                path=path)
        results[n] = per
    return results


def tune_graph(graph, *, n: int = 1, dtype: str = "float32", device=None,
               op: str | None = None, fused: bool = False,
               measure: bool = False, measure_top_k: int = 4,
               include_backward: bool = False, write: bool = True,
               path: str | None = None) -> dict:
    """Tune every conv node of a DAG topology in one sweep
    (``repro/core/autotune.py:722``), the graph analogue of
    :func:`tune_network`: ``graph`` is anything
    ``core.netplan.graph_nodes`` resolves ("resnet18" | "unet" |
    ``list[GraphNode]`` | a linear topology).  The conv nodes go through
    one :func:`tune_network`, keyed as ``ops.conv2d`` looks them up, so
    nodes sharing a problem (ResNet's repeated blocks) are tuned once and
    ``cnn_apply_from_graph`` / ``cnn_pack_params_from_graph`` run on the
    records afterwards.  Joins have nothing to tune.  ``fused=True`` also
    runs :func:`tune_fused_network` over each segment of two or more
    convs (``core.fuse_plan.graph_segments``), writing the
    ``conv2d_fused:`` records its groups read.

    Returns ``{"layers": {node: record}[, "fused": {group: record}]}``."""
    from repro_torch.core.fuse_plan import graph_segments
    from repro_torch.core.netplan import graph_nodes
    nodes = graph_nodes(graph)
    kw = dict(n=n, dtype=dtype, device=device, write=write, path=path)
    out = {"layers": tune_network(
        [nd.layer for nd in nodes if nd.op == "conv"], op=op,
        measure=measure, measure_top_k=measure_top_k,
        include_backward=include_backward, **kw)}
    if fused:
        out["fused"] = {}
        for _, seg_layers in graph_segments(nodes):
            if len(seg_layers) >= 2:
                out["fused"].update(tune_fused_network(list(seg_layers),
                                                       **kw))
    return out


def tune_sharded(x_shape, w_shape, **kwargs) -> dict:
    """Not ported yet: the ``conv2d_shard:`` namespace and the sharded
    conv wait for ROADMAP Queue 1 item 9 (multi-GPU)."""
    raise NotImplementedError(
        "tune_sharded and the conv2d_shard: namespace need the sharded "
        "conv, ROADMAP Queue 1 item 9 (multi-GPU)")


# ---------------------------------------------------------------------------
# Fused residency groups (DESIGN.md §8)
# ---------------------------------------------------------------------------

def fused_key(signature: str, *, n: int = 1, dtype: str = "float32",
              device=None) -> str:
    """Cache key of one fused group: ``conv2d_fused:d<depth>:n<n>:
    <chain>:<dtype>:<backend>`` with ``signature`` the group's per-stage
    chain (:attr:`~repro_torch.core.fuse_plan.FusedGroup.signature`)."""
    depth = signature.count("-") + 1 if signature else 0
    return (f"conv2d_fused:d{depth}:n{n}:{signature}:{dtype}:"
            f"{backend(device)}")


def _valid_fused_record(rec) -> bool:
    return (isinstance(rec, dict)
            and all(_is_int(rec.get(k)) and rec[k] >= 1
                    for k in ("strip_rows", "band_cols")))


def fused_knobs_for(signature: str, *, n: int = 1, dtype: str = "float32",
                    device=None, path: str | None = None) -> dict | None:
    """The cached, structurally valid tile of a fused group, or None: the
    lookup ``FusedGroupPlan.build(use_autotune_cache=True)`` makes (which
    also checks that the tile fits).  Honors
    ``REPRO_TORCH_CONV_AUTOTUNE=0``."""
    if _disabled():
        return None
    key = fused_key(signature, n=n, dtype=dtype, device=device)
    rec = lookup(key, path)
    if rec is None:
        return None
    if not _valid_fused_record(rec):
        _reject(key, f"bad shape/type/knobs: {rec!r}", path)
        return None
    return rec


def tune_fused(layers, *, start: int = 0, pools=None, n: int = 1,
               dtype: str = "float32", device=None, write: bool = True,
               path: str | None = None) -> dict:
    """Tune the tile of one fused group (a layer chain) by the score
    ``FusedGroupPlan`` uses (executed HBM bytes, then executed FLOPs, over
    the tiles whose shared memory fits; model only, as in JAX) and (by
    default) persist it under ``conv2d_fused:``."""
    from repro_torch.core.fuse_plan import _tile_candidates, build_group
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(f"the fused kernel takes float32 or bfloat16, got "
                         f"{dtype!r}")
    dev = resolve_device(device)
    probe = build_group(layers, start, n=n, pools=pools)
    cands = _tile_candidates(layers, start, n=n, pools=pools,
                             dtype_bytes=_dtype_bytes(dtype))
    if not cands:
        raise ValueError(f"no tile of fused group {probe.signature} fits "
                         f"{SMEM_PER_BLOCK} B of shared memory")
    best = min(cands, key=lambda g: (g.hbm_bytes()["total"],
                                     g.executed_flops))
    record = dict(strip_rows=best.strip_rows, band_cols=best.band_cols,
                  depth=best.depth, source="model",
                  hbm_total=best.hbm_bytes()["total"],
                  executed_flops=best.executed_flops, measured_us=None)
    if dtype == "bfloat16":
        record["routes"] = [lay.route for lay in best.layouts]
    if write:
        store(fused_key(best.signature, n=n, dtype=dtype, device=dev),
              record, path)
    return record


def tune_fused_network(network="vgg16", *, n: int = 1,
                       dtype: str = "float32", device=None,
                       write: bool = True, path: str | None = None) -> dict:
    """Tune every fused group of a topology's partition (``FusedGroupPlan``,
    model-driven, no cache): one ``conv2d_fused:`` record per group of
    depth >= 2.  Returns ``{"<first>..<last>": record}``."""
    from repro_torch.core.fuse_plan import FusedGroupPlan
    from repro_torch.core.netplan import infer_pools, network_layers
    layers = list(network_layers(network))
    pools = list(infer_pools(layers))
    dev = resolve_device(device)
    results: dict[str, dict] = {}
    for g in FusedGroupPlan.build(
            layers, n=n, dtype_bytes=_dtype_bytes(dtype)).fused_groups:
        sub = layers[g.start:g.start + g.depth]
        rec = tune_fused(sub, start=g.start,
                         pools=pools[g.start:g.start + g.depth], n=n,
                         dtype=dtype, device=dev, write=write, path=path)
        results[g.label] = dict(rec, key=fused_key(g.signature, n=n,
                                                   dtype=dtype, device=dev))
    return results
