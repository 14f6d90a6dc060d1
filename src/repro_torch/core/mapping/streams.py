"""Worker-stream algebra: the N-D generalization of the paper's interleave.

Every token stream in the worker pipeline — a reader's interleaved load
stream, a compute layer's per-worker output stream — enumerates a *strided
box* of grid sites in row-major order:

    axis b ranges over ``range(start_b, stop_b, step_b)``

with ``step_b == 1`` on every outer axis and ``step == workers`` on the
innermost axis (the interleave).  This single representation covers both
ranks of the paper's hand-built streams:

* 1D reader ``k``:   ``range(k, n, w)``                     (Fig. 4)
* 2D reader ``k``:   all rows x ``range(k, nx, w)``         (§III-B, column
  ownership — identical to the 1D interleave because ``nx % w == 0`` makes
  the flat row-major stream of reader ``k`` exactly ``{f : f mod w == k}``)
* layer-``t`` compute worker ``c``: the interior shrunk by ``t*r`` per face
  with the innermost axis in worker ``c``'s congruence class.

The data-filtering patterns (``0^m 1^n 0^p``, §III-A) generalize to one
*digit window* per axis: a filter keeps stream position ``s`` iff every
row-major digit of ``s`` falls inside its axis's kept window.  The innermost
check is a plain interval comparison (the paper's 1D pattern); each outer
axis adds one ``divmod``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable


@dataclasses.dataclass(frozen=True)
class StreamSpec:
    """A row-major strided box of grid sites: per-axis ``(start, stop, step)``."""

    axes: tuple[tuple[int, int, int], ...]

    @property
    def ndim(self) -> int:
        return len(self.axes)

    @property
    def counts(self) -> tuple[int, ...]:
        return tuple(max(0, -((start - stop) // step))
                     for start, stop, step in self.axes)

    def __len__(self) -> int:
        return math.prod(self.counts)

    def coord(self, s: int) -> tuple[int, ...]:
        """Grid coordinate of stream position ``s`` (row-major digits)."""
        out = []
        for (start, _, step), cnt in zip(reversed(self.axes),
                                         reversed(self.counts)):
            s, d = divmod(s, cnt)
            out.append(start + d * step)
        return tuple(reversed(out))

    def flat_indices(self, grid_shape: tuple[int, ...]) -> list[int]:
        """All sites as flat row-major grid indices, in stream order."""
        strides = row_major_strides(grid_shape)
        base = [range(start, stop, step) for start, stop, step in self.axes]
        out = [0]
        for rng_, st in zip(base, strides):
            out = [f + v * st for f in out for v in rng_]
        return out


def row_major_strides(shape: tuple[int, ...]) -> tuple[int, ...]:
    strides = [1] * len(shape)
    for b in range(len(shape) - 2, -1, -1):
        strides[b] = strides[b + 1] * shape[b + 1]
    return tuple(strides)


@dataclasses.dataclass(frozen=True)
class KeepMask:
    """A compiled N-D ``0^m 1^n 0^p`` pattern over one stream.

    ``windows[b]`` is the kept digit interval ``[ilo, ihi)`` on axis ``b`` of
    the producing stream; ``keep`` evaluates position membership; ``lead`` is
    the stream position of the first kept token (the ``0^m`` prefix) and
    ``kept`` the total number of kept tokens (``sum of 1^n`` blocks).
    """

    windows: tuple[tuple[int, int], ...]
    keep: Callable[[int], bool]
    lead: int
    kept: int


def band_keep(stream: StreamSpec, bands: tuple[tuple[int, int], ...]) -> KeepMask:
    """Compile per-axis coordinate bands ``[lo, hi)`` into a keep-mask.

    Each band's ``lo`` must be congruent to the stream's axis start modulo
    the axis step (guaranteed by the mapper's worker-selection rule), so the
    kept positions form exact digit windows.
    """
    counts = stream.counts
    windows = []
    for (start, stop, step), cnt, (lo, hi) in zip(stream.axes, counts, bands):
        assert (lo - start) % step == 0, (
            f"band lo={lo} not in stream class (start={start}, step={step})")
        ilo = max(0, (lo - start) // step)
        ihi = min(cnt, -((start - hi) // step))
        windows.append((ilo, max(ilo, ihi)))
    kept = math.prod(ihi - ilo for ilo, ihi in windows)
    # stream position of the first kept token
    lead = 0
    for (ilo, _), cnt in zip(windows, counts):
        lead = lead * cnt + ilo
    lead = lead if kept else len(stream)

    if stream.ndim == 1:                      # the paper's 1D 0^m 1^n 0^p
        ilo0, ihi0 = windows[0]

        def keep1(s: int, _lo=ilo0, _hi=ihi0) -> bool:
            return _lo <= s < _hi

        return KeepMask(tuple(windows), keep1, lead, kept)

    # innermost window first; the outermost axis needs no divmod.
    inner = list(zip(counts, windows))[1:][::-1]
    olo, ohi = windows[0]

    def keep(s: int) -> bool:
        for cnt, (ilo, ihi) in inner:
            s, d = divmod(s, cnt)
            if not ilo <= d < ihi:
                return False
        return olo <= s < ohi

    return KeepMask(tuple(windows), keep, lead, kept)
