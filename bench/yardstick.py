"""The benchmark's yardstick: the H100's datasheet peaks, the least time a
stencil call could take on the card, the device operations of a profiler trace, and the
line that names the card and its power limit.

The peaks, the operations term and the bytes rule are copies of the port's
``chip_smoke.py`` (``PEAKS``, ``ops_bound``, ``Case.bound``), kept here so
that a change to the program cannot move what the benchmark measures
against.  Nothing here imports the program.
"""
from __future__ import annotations

import math
import subprocess

# Datasheet peaks of one H100 (dense, no sparsity): HBM bytes/s, FP32
# (non-tensor) flop/s, BF16 and TF32 tensor-core flop/s.
PEAKS = {"sxm": (3.35e12, 67e12, 989e12, 494.5e12),
         "pcie": (2.0e12, 51e12, 756e12, 378e12)}
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float64": 8}


def part_of(card_name: str) -> str:
    """The H100 part whose peaks hold for a card of this name."""
    return "pcie" if "pcie" in card_name.lower() else "sxm"


def ops_bound(flops: float, dtype: str, part: str) -> tuple[float, str]:
    """Least seconds for ``flops`` of products in ``dtype``, and the peak
    that sets it: bfloat16 at the BF16 tensor-core peak; float32 the lesser
    of the FP32 cores' time and of three TF32 products each (3xTF32, the
    least an f32-accurate product takes on the tensor cores), so that a
    tensor-core stencil cannot read over its bound."""
    _, fp32, bf16, tf32 = PEAKS[part]
    if dtype == "bfloat16":
        return flops / bf16, "bf16 tensor cores"
    return min((flops / fp32, "FP32 cores"),
               (3 * flops / tf32, "3xTF32 tensor cores"))


def star_taps(coeffs) -> int:
    """Non-zero taps of a star stencil given per axis."""
    return sum(1 for cs in coeffs for c in cs if c != 0.0)


def least_call(shape, dtype: str, coeffs, timesteps: int,
               part: str) -> tuple[float, str]:
    """Least seconds the card could take for one call of a star stencil of
    ``timesteps`` steps on fields of ``shape``, whatever the kernel, and
    what bounds it: each field read once and written once at the HBM rate,
    or one multiply-add per non-zero tap per point and step (only the work
    the steps need, never a halo a kernel computes again)."""
    points = math.prod(shape)
    t_bytes = 2 * points * ITEMSIZE[dtype] / PEAKS[part][0]
    t_ops, by = ops_bound(2 * star_taps(coeffs) * points * timesteps, dtype,
                          part)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, f"operations, {by}")


def on_device(events) -> list:
    """The operations that ran on the device: its kernels, copies and sets,
    without the device-side copies of the host's annotated ranges."""
    return [e for e in events if e.device_type.name == "CUDA"
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("bench.")]


def device_ops(events) -> dict[str, list]:
    """{name: [device seconds, count]} of every operation the profiler saw
    on the device.  Read from the device events themselves, not from the
    walk of ``chip_smoke.device_profile`` over CPU events and the kernels
    attached to them: the port's ctypes launches go through the CUDA runtime
    linked into each library, which the profiler does not correlate with a
    CPU event, so that walk finds none of K3's or K4's kernels."""
    ops: dict[str, list] = {}
    for e in on_device(events):
        acc = ops.setdefault(e.name, [0.0, 0])
        acc[0] += (e.time_range.end - e.time_range.start) / 1e6
        acc[1] += 1
    return ops


def device_intervals(events) -> list[tuple[float, float]]:
    """(start, end) in seconds of every operation on the device, merged where
    they overlap, in order."""
    spans = sorted((e.time_range.start / 1e6, e.time_range.end / 1e6)
                   for e in on_device(events))
    merged: list[list[float]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_gaps(intervals, host_spans, top: int = 10) -> list[list]:
    """The ``top`` longest gaps between device operations, each labelled by
    the host span (name, start, end in seconds) in flight at its middle."""
    gaps = []
    for (_, a), (b, _) in zip(intervals, intervals[1:]):
        mid = (a + b) / 2
        label = next((n for n, s, e in host_spans if s <= mid <= e),
                     "between spans")
        gaps.append([label, b - a])
    return sorted(gaps, key=lambda g: -g[1])[:top]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"
