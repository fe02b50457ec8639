"""device_idle_pct: the share of the traced window in which no
operation ran on the card, in %: (window - busy union) / window."""


def read(run):
    t = run.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
