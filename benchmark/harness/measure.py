"""The yardstick's arithmetic: the card's peaks, the roofline bound, the
card's name and state, and the reduction of a profiler trace to busy time,
idle share and a breakdown.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_FLOPS``,
``bound``, ``card_name``, ``card_state`` and the arithmetic of
``profile_run``), so that changes to the program leave the benchmark's
numbers alone.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
from typing import Dict, List, NamedTuple, Optional, Tuple

# H100 SXM data sheet, dense rates without sparsity, at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {
    "bfloat16": 989e12,
    "float16": 989e12,
    "tf32": 494.7e12,
    "float32": 67e12,  # the CUDA cores' FMA
}


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """Least seconds the card could take: the larger of the operations over
    ``peak`` and the bytes over the HBM rate."""
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


def _smi(query: str) -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return _smi("name,power.limit")


def card_state() -> str:
    """SM clock, power draw and temperature now, as nvidia-smi reports them."""
    return _smi("clocks.sm,power.draw,temperature.gpu")


class Trace(NamedTuple):
    """Device operations (kernels, copies, memsets) and host operations of
    a profiled slice, times in seconds from the trace's origin."""

    device: List[Tuple[str, float, float]]  # (name, start, duration)
    host: List[Tuple[str, float, float]]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (overlaps once)."""
        total, end = 0.0, float("-inf")
        for _, t, d in sorted(self.device, key=lambda e: e[1]):
            if t + d > end:
                total += t + d - max(t, end)
                end = t + d
        return total

    def span_s(self) -> float:
        if not self.device:
            return 0.0
        return max(t + d for _, t, d in self.device) - min(t for _, t, _ in self.device)

    def time_of(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(d for n, _, d in self.device if match(n))

    def top_ops(self, n: int = 10) -> List[list]:
        by = {}
        for name, _, d in self.device:
            by[name] = by.get(name, 0.0) + d
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest gaps between device operations, each named by the
        innermost host operation running when the gap began."""
        ops = sorted(self.device, key=lambda e: e[1])
        gaps, end = [], None
        for _, t, d in ops:
            if end is not None and t > end:
                gaps.append((t - end, end))
            end = t + d if end is None else max(end, t + d)
        gaps.sort(reverse=True)
        out = []
        for length, start in gaps[:n]:
            covering = [(d, name) for name, t, d in self.host if t <= start < t + d]
            out.append([min(covering)[1] if covering else "(no host op)", length])
        return out


def read_trace(prof) -> Trace:
    """The device and host operations of a finished ``torch.profiler``
    session, from its exported chrome trace (written to a temporary file
    and deleted)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", "?"), e["ts"] * 1e-6, e["dur"] * 1e-6)
        cat = e.get("cat")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append(item)
        elif cat in ("cpu_op", "user_annotation", "python_function"):
            host.append(item)
    return Trace(dev, host)


def breakdown(trace: Optional[Trace]) -> Optional[Dict[str, list]]:
    if trace is None or not trace.device:
        return None
    return {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
