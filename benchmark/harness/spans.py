"""The benchmark's own wrappers around calls into the trace layer, put in
place for the one traced frame or wavefront after the window and taken
out again:

* ``stream_trace.prepare_stream`` and ``stream_trace.coherence_order``
  (the worklists and the presort): a ``record_function`` range named
  ``bench.prepare`` (the trace reduction leaves their kernels out of the
  passes) and a pair of CUDA events each (``prepare_ms``);
* ``restir._closest_dispatch`` / ``restir._any_dispatch``: the batch's
  rays and bounds, for the yardstick of the trace kernels' roofline.

They change no argument and no answer.
"""

from __future__ import annotations

import torch

PREPARE_RANGE = "bench.prepare"


class TraceSpans:
    def __init__(self):
        self.events = []     # (start, end) CUDA events per prepare call
        self.batches = []    # (query, o planes, d planes, t_min, t_max)
        self._saved = []

    def _patch(self, mod, name, fn):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def install(self) -> "TraceSpans":
        from royaltracer_dx_tpu_torch.ops import restir, stream_trace

        def timed(orig):
            def run(*a, **k):
                with torch.profiler.record_function(PREPARE_RANGE):
                    if not torch.cuda.is_available():
                        return orig(*a, **k)
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = orig(*a, **k)
                    e1.record()
                self.events.append((e0, e1))
                return out
            return run

        def planes(a):
            if isinstance(a, (tuple, list)):
                return tuple(a)
            return tuple(a[:, c] for c in range(3))

        closest, any_ = restir._closest_dispatch, restir._any_dispatch

        def closest_dispatch(scene, origins, dirs, cfg, t_min, t_max,
                             coherent=True):
            self.batches.append(("closest", planes(origins), planes(dirs),
                                 t_min, t_max))
            return closest(scene, origins, dirs, cfg, t_min, t_max, coherent)

        def any_dispatch(scene, origins, dirs, cfg, t_min, t_max):
            self.batches.append(("any", planes(origins), planes(dirs),
                                 t_min, t_max))
            return any_(scene, origins, dirs, cfg, t_min, t_max)

        self._patch(stream_trace, "prepare_stream",
                    timed(stream_trace.prepare_stream))
        self._patch(stream_trace, "coherence_order",
                    timed(stream_trace.coherence_order))
        self._patch(restir, "_closest_dispatch", closest_dispatch)
        self._patch(restir, "_any_dispatch", any_dispatch)
        return self

    def remove(self) -> None:
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved = []

    def prepare_ms(self) -> float | None:
        """The prepare calls' event time, summed (after a synchronise);
        None where the traced work made none."""
        if not self.events:
            return None
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.events))
