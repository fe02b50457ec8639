"""The deliberately broken decomposition the linter must catch.

The JAX package's PR 4 fixed a deadlock: the 2D entry took its td/bu
decision from a reduction over the GRAPH axes only, so in a pod-batched
mesh each pod could pick its own body, and the 2D bodies permute, which
the JAX package lowers as a whole-mesh rendezvous: a pod that took the
other body waits forever on a permute its peers never issue.  The fix
(``sync_modes=True`` in ``core/decomp.py``) syncs the decision over the
pods.

This module brings the bug back under a name of its own: the 2D body
with ``sync_modes=False``.  ``divergent_2d_fixture()`` registers it (and
a copy of the 2D dense LocalOps entries) for the length of a ``with``
block and restores the registries on exit, so
``registered_decompositions()`` stays ("1d", "1ds", "2d") everywhere
else.  Rule R1 must flag it on a pod mesh: ``tests/
test_torch_analysis_lint.py`` and the CLI's ``--expect-fixture`` assert
it, the proof that the linter catches the class of bug it exists for.
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager

FIXTURE_NAME = "2d-divergent-fixture"


def _divergent_body_2d(g, roots, **kw):
    """The 2D body with the bug: each pod decides its direction alone
    while the bodies permute over the whole mesh."""
    from repro_torch.core.decomp import _bfs_body_2d
    return _bfs_body_2d(g, roots, sync_modes=False, **kw)


@contextmanager
def divergent_2d_fixture():
    """Scoped registration of the broken entry (and the dense LocalOps
    entries under its name, so plans resolve); yields the entry.  The
    registries are restored on exit, whatever happens inside."""
    from repro_torch.core import decomp, local_ops
    entry = dataclasses.replace(decomp.get_decomposition("2d"),
                                name=FIXTURE_NAME, body=_divergent_body_2d)
    decomp.register_decomposition(entry)
    mirrored = []
    try:
        for d, lm, st in local_ops.registered_combos():
            if d == "2d" and lm == "dense":
                src = local_ops.get_local_ops(d, lm, st)
                local_ops.register_local_ops(
                    dataclasses.replace(src, decomposition=FIXTURE_NAME))
                mirrored.append((FIXTURE_NAME, lm, st))
        yield entry
    finally:
        for key in mirrored:
            local_ops.unregister_local_ops(*key)
        decomp.unregister_decomposition(FIXTURE_NAME)


def lint_fixture(instrument: bool = False, device="cuda"):
    """Lint the broken entry's pod-batched search; returns the findings
    (callers assert that R1 is among them)."""
    from repro_torch.analysis.registry import lint_plan, plan_case
    with divergent_2d_fixture():
        plan = plan_case(FIXTURE_NAME, {}, instrument=instrument,
                         batched=True, device=device)
        return lint_plan(plan, pod_axis="pod",
                         combo=f"{FIXTURE_NAME}/"
                               f"{'instr' if instrument else 'fast'}")
