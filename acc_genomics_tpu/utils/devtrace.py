"""Device time from a ``jax.profiler`` trace, and compiled-program memory.

``device_time(fn)`` runs ``fn`` once under the profiler and reduces the
trace to what the accelerator did: the busy time (union of the kernel
intervals on the device planes), the window it spans, and the summed
duration per kernel name.  Host clocks around ``block_until_ready``
give the caller-side time; this gives the device side of the same work.

``compiled_programs()`` records every executable XLA builds (or loads
from the persistent cache) while it is active, so a caller can print
each one's ``memory_analysis`` without knowing which jitted functions
the engines call.
"""

from __future__ import annotations

import contextlib
import glob
import os
import tempfile
import time


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path: str, top: int = 12) -> dict:
    """Reduce an ``.xplane.pb`` file to device busy time and per-kernel
    sums.  Device planes are those named ``/device:GPU:*``; a line whose
    name starts with "XLA" carries module/op annotations that duplicate
    the kernel events, so only the other lines (the streams) count."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(path)
    spans, per_kernel, lines = [], {}, {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if line.name.startswith("XLA"):
                continue
            for ev in evs:
                s = ev.start_ns
                spans.append((s, s + ev.duration_ns))
                k = per_kernel.setdefault(ev.name, [0, 0])
                k[0] += 1
                k[1] += ev.duration_ns
    busy = _union_ns(spans)
    window = (max(e for _, e in spans) - min(s for s, _ in spans)) if spans else 0
    kernels = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:top]
    return dict(
        busy_ms=busy / 1e6,
        window_ms=window / 1e6,
        n_events=len(spans),
        kernels=[(n, c, t / 1e6) for n, (c, t) in kernels],
        lines=lines,
    )


def device_time(fn, logdir: str | None = None) -> dict:
    """Run ``fn()`` once under the profiler (it must block until its
    device work is done) and return ``reduce_trace`` of the trace plus
    the host wall time of the traced call.  Without ``logdir`` the trace
    goes to a temporary directory that is removed afterwards."""
    import jax

    if logdir is None:
        with tempfile.TemporaryDirectory(prefix="trace_") as tmp:
            return device_time(fn, tmp)
    with jax.profiler.trace(logdir):
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise RuntimeError(f"profiler wrote no trace under {logdir}")
    out = reduce_trace(paths[-1])
    out["host_ms"] = wall * 1e3
    return out


@contextlib.contextmanager
def compiled_programs():
    """Yield a dict that fills with ``{program name: executable}`` for
    every program compiled (or loaded from the compile cache) inside the
    block.  ``executable.get_compiled_memory_stats()`` is what
    ``jax.stages.Compiled.memory_analysis()`` returns.

    It wraps the one function every jit compile goes through
    (``pxla._cached_compilation``); a JAX without it raises here rather
    than recording nothing."""
    from jax._src.interpreters import pxla

    orig = pxla._cached_compilation
    seen: dict = {}

    def recording(computation, name, *args, **kwargs):
        exe = orig(computation, name, *args, **kwargs)
        key = name
        k = 1
        while key in seen and seen[key] is not exe:
            k += 1
            key = f"{name}#{k}"
        seen[key] = exe
        return exe

    pxla._cached_compilation = recording
    try:
        yield seen
    finally:
        pxla._cached_compilation = orig


def memory_line(name: str, exe) -> str:
    """One line of an executable's compiled memory analysis (bytes)."""
    m = exe.get_compiled_memory_stats()
    return (
        f"{name}: args={m.argument_size_in_bytes} "
        f"out={m.output_size_in_bytes} temp={m.temp_size_in_bytes} "
        f"alias={m.alias_size_in_bytes} "
        f"code={m.generated_code_size_in_bytes}"
    )
