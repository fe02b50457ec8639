"""Shared test config.

Two jobs:

1. Register the ``slow`` marker (subprocess system tests >60 s) so the CI
   fast lane can deselect them with ``-m "not slow"``.

2. Provide a *fallback* ``hypothesis`` shim when the real package is not
   installed (it is declared in requirements-dev.txt, but the tier-1 run
   must collect and pass without it).  The shim implements exactly the
   surface these tests use — ``@given(st.integers(a, b), ...)`` plus
   ``@settings(max_examples=, deadline=)`` — by re-running the test body
   ``max_examples`` times on values drawn from a *seeded* per-test RNG,
   so runs are deterministic (no shrinking, no example database).
"""
from __future__ import annotations

import sys
import types
import zlib


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: subprocess system test (>60s); deselect with "
        "-m 'not slow' for the fast CI lane")
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels have no "
        "CPU mode); skips without one")


def _install_hypothesis_shim():
    class _Strategy:
        def __init__(self, draw):
            self._draw = draw

    class _strategies(types.ModuleType):
        @staticmethod
        def integers(min_value=0, max_value=1 << 30):
            return _Strategy(
                lambda rng: int(rng.integers(min_value, max_value + 1)))

        @staticmethod
        def floats(min_value=0.0, max_value=1.0, **_kw):
            return _Strategy(
                lambda rng: float(rng.uniform(min_value, max_value)))

        @staticmethod
        def booleans():
            return _Strategy(lambda rng: bool(rng.integers(0, 2)))

        @staticmethod
        def sampled_from(seq):
            seq = list(seq)
            return _Strategy(lambda rng: seq[int(rng.integers(len(seq)))])

    def settings(max_examples: int = 20, deadline=None, **_kw):
        def deco(f):
            f._shim_max_examples = max_examples
            return f
        return deco

    def given(*strats):
        def deco(f):
            def wrapper():
                # zero-arg on purpose: pytest must not see the strategy
                # parameters of ``f`` as fixtures (no __wrapped__ either,
                # or inspect.signature would follow it back to ``f``)
                import numpy as np
                # read max_examples lazily so @settings works in either
                # decorator order (above @given it lands on the wrapper)
                n = getattr(wrapper, "_shim_max_examples",
                            getattr(f, "_shim_max_examples", 20))
                seed = zlib.crc32(f.__qualname__.encode())
                rng = np.random.default_rng(seed)
                for _ in range(n):
                    vals = [s._draw(rng) for s in strats]
                    f(*vals)
            for attr in ("__name__", "__qualname__", "__module__", "__doc__"):
                setattr(wrapper, attr, getattr(f, attr))
            return wrapper
        return deco

    mod = types.ModuleType("hypothesis")
    st_mod = _strategies("hypothesis.strategies")
    mod.given = given
    mod.settings = settings
    mod.strategies = st_mod
    mod.__is_repro_shim__ = True
    sys.modules["hypothesis"] = mod
    sys.modules["hypothesis.strategies"] = st_mod


try:  # prefer the real package when available
    import hypothesis  # noqa: F401
except ImportError:
    _install_hypothesis_shim()
