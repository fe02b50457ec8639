"""search_ms_p95: the 95th percentile of one search's time, in ms, over
every search of the window (cells of one root a call)."""
import numpy as np


def read(run):
    if run.roots_per_call != 1 or len(run.times) < 20:
        return None
    return float(np.percentile(np.asarray(run.times) * 1e3, 95))
