"""Pareto machinery for the mapping auto-tuner.

The tuner judges a mapping by the objective vector

    (workload cycles, PEs used, max channel load)

— lower is better on every axis.  A config *dominates* another when it is no
worse everywhere and strictly better somewhere; the *front* is the set of
measured points no other measured point dominates.  ``best()`` breaks the
front's ties lexicographically (cycles first — the paper's figure of merit —
then PE footprint, then link pressure).
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence, TypeVar

T = TypeVar("T")


def dominates(a: Sequence[float], b: Sequence[float]) -> bool:
    """True iff objective vector ``a`` dominates ``b`` (minimization)."""
    if len(a) != len(b):
        raise ValueError(f"objective ranks differ: {len(a)} vs {len(b)}")
    return all(x <= y for x, y in zip(a, b)) and any(
        x < y for x, y in zip(a, b))


def pareto_front(points: Iterable[T],
                 key: Callable[[T], Sequence[float]] = lambda p: p  # type: ignore[assignment,return-value]
                 ) -> list[T]:
    """The non-dominated subset of ``points``, in first-seen order.

    Points with *equal* objective vectors neither dominate each other, so
    ties all survive — callers that want one representative per vector can
    dedupe on ``key``.
    """
    pts = list(points)
    objs = [tuple(key(p)) for p in pts]
    front = []
    for i, p in enumerate(pts):
        if not any(dominates(objs[j], objs[i])
                   for j in range(len(pts)) if j != i):
            front.append(p)
    return front


def assert_non_dominated(points: Iterable[T],
                         key: Callable[[T], Sequence[float]] = lambda p: p  # type: ignore[assignment,return-value]
                         ) -> None:
    """Raise ``AssertionError`` naming the offending pair if any point in
    ``points`` dominates another — the artifact-verification gate."""
    pts = list(points)
    objs = [tuple(key(p)) for p in pts]
    for i in range(len(pts)):
        for j in range(len(pts)):
            if i != j and dominates(objs[i], objs[j]):
                raise AssertionError(
                    f"front is internally dominated: {objs[i]} (point {i}) "
                    f"dominates {objs[j]} (point {j})")


def best_point(points: Iterable[T],
               key: Callable[[T], Sequence[float]] = lambda p: p  # type: ignore[assignment,return-value]
               ) -> T:
    """Lexicographic minimum of the objective vectors (cycles, PEs, load)."""
    pts = list(points)
    if not pts:
        raise ValueError("no points to choose from")
    return min(pts, key=lambda p: tuple(key(p)))
