"""setup_s: seconds from the process's start to the window's: loading,
the harness's inputs, the port's build and session, the warm-up calls
(and, in a checkout's first run, the kernels' compilation)."""


def read(run):
    return run.setup.get("setup_s")
