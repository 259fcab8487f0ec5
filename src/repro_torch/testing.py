"""Fixed-seed fallbacks for the optional ``hypothesis`` dependency.

The port's copy of ``repro.testing``: the same strategies, seed and
draws. Tests import property-testing decorators via::

    try:
        from hypothesis import given, settings, strategies as st
    except ModuleNotFoundError:
        from repro_torch.testing import given, settings, st

When hypothesis is absent, ``given`` degrades to running the test body over
a deterministic, fixed-seed sample of each strategy (no shrinking, no
database) so the suite still collects and exercises the properties.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np

_FALLBACK_SEED = 0xF411BACC
_MAX_EXAMPLES = 25  # cap fallback sampling; hypothesis gets the full budget


class _Strategy:
    def __init__(self, draw):
        self._draw = draw

    def example(self, rng: np.random.Generator):
        return self._draw(rng)


class st:
    """Mirror of the ``hypothesis.strategies`` entry points the tests use."""

    @staticmethod
    def integers(min_value: int, max_value: int) -> _Strategy:
        return _Strategy(
            lambda rng: int(rng.integers(min_value, max_value + 1)))

    @staticmethod
    def sampled_from(elements) -> _Strategy:
        seq = list(elements)
        return _Strategy(lambda rng: seq[int(rng.integers(len(seq)))])


def settings(max_examples: int = 10, **_ignored):
    def deco(fn):
        fn._fallback_max_examples = max_examples
        return fn
    return deco


def given(**strategies):
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            # Read at call time: @settings may sit above @given (it then
            # decorates the wrapper) or below it (it decorated fn).
            n = min(getattr(wrapper, "_fallback_max_examples",
                            getattr(fn, "_fallback_max_examples", 10)),
                    _MAX_EXAMPLES)
            rng = np.random.default_rng(_FALLBACK_SEED)
            for _ in range(n):
                drawn = {k: s.example(rng) for k, s in strategies.items()}
                fn(*args, **drawn, **kw)
        # The drawn params are filled here, not by pytest: hide the original
        # signature so pytest does not look for same-named fixtures.
        wrapper.__dict__.pop("__wrapped__", None)
        wrapper.__signature__ = inspect.Signature()
        return wrapper
    return deco
