"""teps: m_input edges times the searches completed in the window, over
the summed time of the window's calls (each up to its synchronize): all
the work over all the time, which with one m_input for every root is
Graph500's harmonic mean of the searches' TEPS."""
from bench.costs import teps


def read(run):
    if not run.times:
        return None
    searches = len(run.times) * run.roots_per_call
    return teps(run.m_input * searches, sum(run.times) + run.lost_s)
