"""peak_gib: the port's peak device memory (``max_memory_allocated``)
over its build, its session, the warm-up and the window, in GiB; the
parents the harness holds for the check are taken out of the window's
reading, and its input edge list counts only while the build holds it."""


def read(run):
    if run.device.type != "cuda":
        return None
    return run.port_peak_bytes / 2**30
