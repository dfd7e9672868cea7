"""Spans and counters of the port's frames and trace batches, kept in
memory.

Spans.  ``span(name)`` marks a stretch of host time:
  * with the profiler off it reads the profiler's flag and takes two host
    timestamps (``time.time_ns()``, the clock of the profiler's Chrome
    trace: a range's ``ts`` plus the trace's ``baseTimeNanoseconds``) into
    the open frame's record, and nothing else: ``record_function`` costs
    ~15 us even with the profiler off;
  * with the profiler on it also opens ``record_function("rt.<name>")``,
    so the range sits in the trace beside the kernels launched inside it.
The names: ``frame`` (``frame()``); the passes ``pass1_di``, ``pass1_gi``,
``pass2_temporal`` (``pack_last`` inside it), ``pass3_spatial`` and
``accumulate``; ``trace.<query>.<route>`` around each trace batch
(``trace()``), ``trace.prepare`` around the stream worklists and presort;
``sync.<site>`` around each call of a frame that makes the host wait for
the device.  A span given a ``tick`` label books profile mode's pass time
on exit (``PassTimer``).  ``update`` (``update()``) spans a renderer's
scene update, outside any frame, with ``update.bake`` (the world bake),
``update.refit`` (the stream refit, or the LBVH refit / cluster rebuild),
``update.lights`` (the light table) and ``update.table`` (the world bounds
and the triangle table) inside it (``Scene.flatten(prev=)``).

Counters, in the same record: per trace batch its query, route and ray
count (host integers the dispatch has); the stream kernels' walk stats
(blocks visited, clusters tested, ray-cluster candidate pairs), summed on
the tensors' device into an int64 [3] counter (``stream_counter``) that
the kernel adds to with one atomicAdd a column from each chunk that
walked, and the plain CPU version with a torch sum.  No host read.  A
record counts host integers by name (``count()``): a frame its light
picks (``light_pick.calls``) and their lanes (``light_pick.lanes``), an
update the triangles re-baked and the stream slots re-laid.

The record keeps the last ``KEEP_FRAMES`` frames and, apart, the last
``KEEP_FRAMES`` updates, each marked with whether the profiler was on,
and running totals of the batches traced outside any frame.  Only the
readers, ``last_frame()``, ``last_update()`` and ``outside_frames()``,
move device counters to the host, and only when called.
"""

from __future__ import annotations

import collections
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "rt."
KEEP_FRAMES = 4
STREAM_STATS = ("blocks", "clusters", "pairs")
# rows of a device's frame-counter buffer: each frame that launches a
# stream kernel there takes the next one, and a fresh zeroed buffer comes
# once every row has been taken (one allocation and memset per _ROWS
# frames)
_ROWS = 64


class PassTimer:
    """Profile mode's pass times: at the exit of a span given a ``tick``
    label, wait for ``devices`` and book the time since the previous tick
    (or since this timer was made) under the label in ``times``.  Every
    tick is a synchronisation, so the times are indicative, not additive.
    """

    def __init__(self, devices, times: dict):
        self.devices = [torch.device(d) for d in devices]
        self.times = times
        self.t0 = time.perf_counter()

    def tick(self, label: str) -> None:
        for d in self.devices:
            if d.type == "cuda":
                with span("sync.pass_timer"):
                    torch.cuda.synchronize(d)
        now = time.perf_counter()
        self.times[label] = now - (self.t0 + sum(self.times.values()))


class _Frame:
    """The record of one frame or one update."""

    __slots__ = ("profiled", "spans", "batches", "counters", "counts",
                 "timer")

    def __init__(self, profiled: bool, timer):
        self.profiled = profiled
        self.spans = []          # (name, start ns, end ns)
        self.batches = []        # (query, route, rays)
        self.counters = {}       # device -> int64 [3] stream counter
        self.counts = {}         # name -> host int (count())
        self.timer = timer


class Record:
    """The frames and the outside-frame totals of one process."""

    def __init__(self):
        self.frames = collections.deque(maxlen=KEEP_FRAMES)
        self.updates = collections.deque(maxlen=KEEP_FRAMES)
        self.current = None
        self.outside_batches = {}     # "query.route" -> [batches, rays]
        self.outside_counters = {}    # device -> int64 [3]
        self._rows = {}               # device -> [buffer [_ROWS, 3], next]

    def stream_counter(self, device) -> torch.Tensor:
        dev = torch.device(device)
        fr = self.current
        if fr is None:
            c = self.outside_counters.get(dev)
            if c is None:
                c = self.outside_counters[dev] = torch.zeros(
                    3, dtype=torch.int64, device=dev)
            return c
        c = fr.counters.get(dev)
        if c is None:
            buf = self._rows.get(dev)
            if buf is None or buf[1] == _ROWS:
                buf = self._rows[dev] = [torch.zeros(
                    (_ROWS, 3), dtype=torch.int64, device=dev), 0]
            c = fr.counters[dev] = buf[0][buf[1]]
            buf[1] += 1
        return c

    def add_batch(self, query: str, route: str, rays: int) -> None:
        fr = self.current
        if fr is not None:
            fr.batches.append((query, route, rays))
            return
        tot = self.outside_batches.setdefault(f"{query}.{route}", [0, 0])
        tot[0] += 1
        tot[1] += rays


RECORD = Record()


class _Span:
    __slots__ = ("name", "tick", "rf", "t0")

    def __init__(self, name: str, tick=None):
        self.name = name
        self.tick = tick

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        else:
            self.rf = None
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        fr = RECORD.current
        if fr is not None:
            if self.tick is not None and fr.timer is not None:
                fr.timer.tick(self.tick)
            fr.spans.append((self.name, self.t0, time.time_ns()))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class _FrameSpan(_Span):
    """A span that opens its own record (a frame's or an update's) and
    keeps it in ``RECORD.<kept>`` on exit."""

    __slots__ = ("timer", "outer", "kept")

    def __init__(self, name: str = "frame", kept: str = "frames",
                 timer=None):
        super().__init__(name)
        self.kept = kept
        self.timer = timer

    def __enter__(self):
        self.outer = RECORD.current
        RECORD.current = _Frame(bool(_profiler._is_profiler_enabled),
                                self.timer)
        return super().__enter__()

    def __exit__(self, *exc):
        fr = RECORD.current
        super().__exit__(*exc)
        getattr(RECORD, self.kept).append(fr)
        RECORD.current = self.outer
        return False


def span(name: str, tick: str | None = None) -> _Span:
    """A context manager spanning ``name`` (``rt.<name>`` in a profile);
    with ``tick``, profile mode books the pass time under that label on
    exit."""
    return _Span(name, tick)


def frame(timer: PassTimer | None = None) -> _FrameSpan:
    """The span of one rendered frame, ``rt.frame``: opens the frame's
    record, into which the spans and counters inside it go."""
    return _FrameSpan(timer=timer)


def update() -> _FrameSpan:
    """The span of one scene update (a renderer's ``update()``),
    ``rt.update``: opens the update's record, into which the
    ``update.*`` spans, the waits and the counts inside it go."""
    return _FrameSpan("update", "updates")


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the open record's count ``name``
    (nothing outside a record)."""
    fr = RECORD.current
    if fr is not None:
        fr.counts[name] = fr.counts.get(name, 0) + int(n)


def trace(query: str, route: str, rays: int) -> _Span:
    """Count one trace batch (query "closest" or "any", the route the
    dispatch took, its ray count) and span it as
    ``trace.<query>.<route>``."""
    RECORD.add_batch(query, route, rays)
    return _Span(f"trace.{query}.{route}")


def to_device(site: str, value, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)``.  Copying a
    host value (a Python number or list, a numpy array, a CPU tensor) to
    a card is a blocking copy that waits for the card's stream: that copy
    is spanned as ``sync.<site>``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not (torch.is_tensor(value) and value.is_cuda):
        with _Span("sync." + site):
            return torch.as_tensor(value, dtype=dtype, device=dev)
    return torch.as_tensor(value, dtype=dtype, device=dev)


def stream_counter(device) -> torch.Tensor:
    """The int64 [3] counter on ``device`` that a stream kernel launched
    now adds its walk stats to: the open frame's, else the outside
    total."""
    return RECORD.stream_counter(device)


def count_stream(stats: torch.Tensor) -> None:
    """Add a plain stream call's per-chunk stats [chunks, 3] to the
    counter of their device (the CUDA kernels add theirs themselves)."""
    RECORD.stream_counter(stats.device).add_(stats.sum(dim=0))


def _stream_totals(counters) -> dict:
    total = [0, 0, 0]
    for c in counters:
        total = [a + b for a, b in zip(total, c.tolist())]
    return dict(zip(STREAM_STATS, total))


def last_frame(profiled: bool = False) -> dict | None:
    """The newest recorded frame rendered with the profiler on (or off):
    dict(profiled, spans [(name, start ns, end ns)] in the order they
    ended, batches [(query, route, rays)], stream {blocks, clusters,
    pairs}, counts {name: int}); None where the record holds no such
    frame."""
    for fr in reversed(RECORD.frames):
        if fr.profiled == profiled:
            return dict(profiled=fr.profiled, spans=list(fr.spans),
                        batches=list(fr.batches),
                        stream=_stream_totals(fr.counters.values()),
                        counts=dict(fr.counts))
    return None


def last_update(profiled: bool = False) -> dict | None:
    """The newest recorded update made with the profiler on (or off):
    dict(profiled, spans [(name, start ns, end ns)] in the order they
    ended, counts {name: int}); None where the record holds no such
    update."""
    for up in reversed(RECORD.updates):
        if up.profiled == profiled:
            return dict(profiled=up.profiled, spans=list(up.spans),
                        counts=dict(up.counts))
    return None


def outside_frames() -> dict:
    """The running totals of every batch traced outside a frame:
    dict(batches {"query.route": [batches, rays]}, stream {blocks,
    clusters, pairs})."""
    return dict(batches={k: list(v) for k, v in
                         RECORD.outside_batches.items()},
                stream=_stream_totals(RECORD.outside_counters.values()))


def reset() -> None:
    """Forget every frame and total (the tests start from here)."""
    global RECORD
    RECORD = Record()
