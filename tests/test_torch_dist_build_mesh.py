"""The port's born-sharded build on the simulated 4-, 7- and 16-strip
and 2x2/2x4/4x4 meshes against the JAX package's ``dist_build`` on 16
forced host devices, in one subprocess (``_torch_dist_build_main.py``,
about 20 s): every field, ``m``, the capacities, ``cap_route``, the
three route-word figures and the healed ``retry_log`` of a squeezed
``route_slack`` equal."""
import os
import subprocess
import sys
from _torch_threads import ONE_THREAD_ENV

_HERE = os.path.dirname(__file__)


def test_dist_build_matches_reference_on_meshes():
    env = dict(os.environ, JAX_PLATFORMS="cpu", **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable,
                        os.path.join(_HERE, "_torch_dist_build_main.py")],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"{r.stdout}\n{r.stderr}"
    assert "OK torch-dist-build (8 builds)" in r.stdout
