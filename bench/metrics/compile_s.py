"""compile_s: the session's seconds, ``BFSEngine.ship_s +
compile_s`` (the graph shipped, the kernels loaded, one warm-up search)
plus ``batch_compile_s`` where the traffic batches roots."""


def read(run):
    if "compile_s" not in run.setup:
        return None
    return run.setup["ship_s"] + run.setup["compile_s"]
