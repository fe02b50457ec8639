"""The port's collective budgets and the word forms it added to
``core/comm_model.py``, against the JAX package's, tolerance 0: the
budgets over the whole cross product of the registry's schedule domains
x mode x grid 1..8, with the same errors for the values they do not
model; the padded, hybrid and strip-pointer word forms on seeded
inputs."""
import itertools

import numpy as np
import pytest

from repro.core import comm_model as R
from repro_torch.analysis.registry import SCHEDULE_DOMAINS
from repro_torch.core import comm_model as T
from _torch_threads import one_thread  # noqa: F401

DECOMPS = ("2d", "1d", "1ds", "3d")
MODES = ("td", "bu", "fold")
# the registry's domains plus the values the budgets refuse
FOLDS = SCHEDULE_DOMAINS["fold_mode"] + ("bitmap_pure", "psum")
CODECS = SCHEDULE_DOMAINS["frontier_codec"] + ("zstd",)
CHUNKS = (0,) + SCHEDULE_DOMAINS["expand_chunks"] + (4,)


def _outcome(fn, *a, **kw):
    try:
        return ("ok", fn(*a, **kw))
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("decomposition", DECOMPS)
def test_level_collective_budget_equals_reference(decomposition):
    n = 0
    for mode, pc, fold, compact, codec, chunks in itertools.product(
            MODES, range(1, 9), FOLDS, (False, True), CODECS, CHUNKS):
        kw = dict(fold_mode=fold, compact_updates=compact, codec=codec,
                  expand_chunks=chunks)
        want = _outcome(R.level_collective_budget, decomposition, mode, pc,
                        **kw)
        got = _outcome(T.level_collective_budget, decomposition, mode, pc,
                       **kw)
        assert got == want, (decomposition, mode, pc, kw)
        n += want[0] == "ok"
    # the registered entries have budgets; "3d" has none
    assert (n > 0) == (decomposition != "3d")


@pytest.mark.parametrize("decomposition", DECOMPS)
def test_level_budgets_for_equals_reference(decomposition):
    for pc, p, fold, compact, codec, chunks in itertools.product(
            range(1, 9), range(1, 9), FOLDS, (False, True), CODECS,
            CHUNKS):
        kw = dict(pc=pc, p=p, fold_mode=fold, compact_updates=compact,
                  frontier_codec=codec, expand_chunks=chunks)
        assert (_outcome(T.level_budgets_for, decomposition, **kw)
                == _outcome(R.level_budgets_for, decomposition, **kw)), kw


def test_word_forms_equal_reference():
    rng = np.random.default_rng(24)
    for _ in range(200):
        p = int(rng.integers(1, 65))
        n = p * 32 * int(rng.integers(1, 1 << 12))
        cap_x = 32 * int(rng.integers(1, 64))
        bits = int(rng.integers(1, 33))
        n_f = float(rng.integers(0, n + 1))
        n_max = float(rng.integers(0, 2 * cap_x))
        nzc = float(rng.integers(0, 16 * n))
        assert (T.compressed_expand_padded_words(cap_x, p, bits)
                == R.compressed_expand_padded_words(cap_x, p, bits))
        assert (T.sparse_expand_padded_words(cap_x, p)
                == R.sparse_expand_padded_words(cap_x, p))
        for b in (0, bits):
            assert (T.hybrid_expand_1d_level_words(n_max, n_f, n, p, cap_x,
                                                   b)
                    == R.hybrid_expand_1d_level_words(n_max, n_f, n, p,
                                                      cap_x, b))
        assert T.strip_csr_pointer_words(n, p) == \
            R.strip_csr_pointer_words(n, p)
        assert T.strip_dcsc_pointer_words(nzc, p) == \
            R.strip_dcsc_pointer_words(nzc, p)
