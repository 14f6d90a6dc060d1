"""A tiny, deterministic subset of the `hypothesis` API (fallback shim),
carried over from ``repro.testing.minihyp``: for the same test qualname it
draws the reference's examples.

The tier-1 property sweeps (``tests/test_property.py`` and the port's
``tests/test_torch_property.py``) are written against hypothesis.  Some
CI containers cannot install extra packages, and skipping the sweep
silently drops the strongest invariant tests in the suite — so this module
implements just enough of the API for the sweep to *run*:

* strategies: ``integers``, ``floats``, ``lists``, ``tuples``,
  ``sampled_from``, ``booleans``, ``composite``
* decorators: ``given`` (positional strategies), ``settings``
  (``max_examples`` honoured, ``deadline`` ignored)

Differences from real hypothesis — by design, not accident:

* **No shrinking.**  A failing example is reported verbatim (the values are
  embedded in the raised ``AssertionError``), not minimized.
* **Deterministic.**  Example ``i`` of test ``f`` is drawn from
  ``sha256(f.__qualname__, i)`` — every run explores the same points, so CI
  failures reproduce locally without a database.
* **No assume/target/example decorators** — the sweep doesn't use them.

When real hypothesis is installed, the sweeps prefer it; this shim only
keeps the sweep alive without it.  Example count can be
globally capped with the ``REPRO_MINIHYP_EXAMPLES`` env var (CI knob).
"""
from __future__ import annotations

import functools
import hashlib
import inspect
import os
import random


class Strategy:
    """A value generator: ``sample(rng) -> value``."""

    def __init__(self, sample_fn, label: str = "strategy"):
        self._sample = sample_fn
        self.label = label

    def sample(self, rng: random.Random):
        return self._sample(rng)

    def __repr__(self):
        return f"minihyp.{self.label}"


def integers(min_value: int, max_value: int) -> Strategy:
    if min_value > max_value:
        raise ValueError("integers: min_value > max_value")
    return Strategy(lambda rng: rng.randint(min_value, max_value),
                    f"integers({min_value},{max_value})")


def floats(min_value: float, max_value: float, *, allow_nan: bool = False,
           allow_infinity: bool = False, width: int = 64) -> Strategy:
    del allow_nan, allow_infinity  # bounded draws are always finite here

    def draw(rng: random.Random) -> float:
        v = rng.uniform(min_value, max_value)
        if width == 32:        # round-trip through float32 like hypothesis
            import struct
            v = struct.unpack("f", struct.pack("f", v))[0]
            v = min(max(v, min_value), max_value)
        return v
    return Strategy(draw, f"floats({min_value},{max_value})")


def booleans() -> Strategy:
    return Strategy(lambda rng: bool(rng.getrandbits(1)), "booleans()")


def lists(elements: Strategy, *, min_size: int = 0,
          max_size: int = 10) -> Strategy:
    return Strategy(
        lambda rng: [elements.sample(rng)
                     for _ in range(rng.randint(min_size, max_size))],
        f"lists({elements.label})")


def tuples(*strategies: Strategy) -> Strategy:
    return Strategy(lambda rng: tuple(s.sample(rng) for s in strategies),
                    "tuples(...)")


def sampled_from(seq) -> Strategy:
    pool = list(seq)
    if not pool:
        raise ValueError("sampled_from: empty sequence")
    return Strategy(lambda rng: pool[rng.randrange(len(pool))],
                    "sampled_from(...)")


def composite(fn):
    """``@composite def strat(draw, *args): ...`` — returns a strategy
    factory, exactly like hypothesis's signature."""
    @functools.wraps(fn)
    def factory(*args, **kwargs) -> Strategy:
        def draw_value(rng: random.Random):
            return fn(lambda s: s.sample(rng), *args, **kwargs)
        return Strategy(draw_value, f"composite:{fn.__name__}")
    return factory


def settings(**kwargs):
    """Record settings on the test function; ``given`` reads them.  Only
    ``max_examples`` has effect (``deadline`` etc. are accepted+ignored)."""
    def deco(fn):
        fn._minihyp_settings = dict(kwargs)
        return fn
    return deco


def _example_rng(qualname: str, index: int) -> random.Random:
    seed = int.from_bytes(
        hashlib.sha256(f"{qualname}:{index}".encode()).digest()[:8], "big")
    return random.Random(seed)


def given(*strategies: Strategy):
    """Run the wrapped test once per deterministic example, passing drawn
    values positionally after any pytest-supplied args."""
    if not strategies:
        raise ValueError("given() needs at least one strategy")

    def deco(fn):
        n = getattr(fn, "_minihyp_settings", {}).get("max_examples", 25)
        env_cap = os.environ.get("REPRO_MINIHYP_EXAMPLES")
        if env_cap:
            n = min(n, max(1, int(env_cap)))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            qual = f"{fn.__module__}.{fn.__qualname__}"
            for i in range(n):
                rng = _example_rng(qual, i)
                values = [s.sample(rng) for s in strategies]
                try:
                    fn(*args, *values, **kwargs)
                except Exception as e:
                    raise AssertionError(
                        f"minihyp falsified {fn.__qualname__} on example "
                        f"{i}/{n}: args={values!r}: "
                        f"{type(e).__name__}: {e}") from e
        # hide the drawn parameters from pytest's fixture resolution (the
        # strategies supply them), like hypothesis does
        del wrapper.__wrapped__
        wrapper.__signature__ = inspect.Signature()
        wrapper.minihyp = True
        return wrapper
    return deco


class _StrategiesNamespace:
    """``from repro_torch.testing.minihyp import strategies as st`` mirror."""
    integers = staticmethod(integers)
    floats = staticmethod(floats)
    booleans = staticmethod(booleans)
    lists = staticmethod(lists)
    tuples = staticmethod(tuples)
    sampled_from = staticmethod(sampled_from)
    composite = staticmethod(composite)


strategies = _StrategiesNamespace()
