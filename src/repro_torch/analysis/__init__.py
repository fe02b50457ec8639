"""Checks of the collective schedule that the port's sessions issue.

The JAX package analyses its traced programs (the jaxpr and the lowered
HLO) for the hazards of an SPMD schedule.  The port runs its meshes as
tensor ops on one device, so it checks the schedule a search really
issues: every collective goes through ``core/collectives.py``, and a
``ScheduleRecorder`` files each one under its level, mode and pod.  The
rules over that record:

  R1 divergent-collective   a level's collective rendezvouses on an
                            axis its direction decision is not uniform
                            over (the deadlock that ``decomp``'s
                            ``sync_modes`` prevents)
  R2 branch-schedule-mismatch  the td and bu levels issue different
                            (kind, axes) sequences while the decision
                            can diverge over axes those rendezvous on
  R3 unknown-axis/pod-leak  a data collective over the pod axis, a
                            collective over an axis outside the entry's
                            layout, or an entry whose ``rendezvous_axes``
                            under-claims what it issued
  R4 budget-drift           a level's recorded count against
                            ``comm_model.level_collective_budget``,
                            over every case of ``registry.budget_cases``

Entry points: ``python -m repro_torch.analysis.lint`` (the CLI),
``BFSPlan.lint()`` and ``BFSEngine.collective_counts()``
(``core/engine.py``), and the pieces: ``uniformity`` (the decision's
uniformity and each collective's rendezvous), ``rules``, ``registry``
(the combo and budget sweeps) and ``fixtures`` (a 2D entry with the
unsynced decision the rules must catch).
"""
