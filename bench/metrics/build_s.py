"""build_s: host seconds of the port's graph build, the dedup and
symmetrize (``graph/rmat.py::preprocess``) and the 2D blocked graph
(``graph/formats.py::build_blocked``), up to a synchronize."""


def read(run):
    return run.setup.get("build_s")
