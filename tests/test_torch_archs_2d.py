"""Every registered 2D ``bfs-rmat*`` arch of the port (the bitmap fold,
compact updates, edge-row reads, the R/G ring) against the JAX package's
dense session of the same arch on 2x2 and 4x4 grids of 16 forced host
devices, in the port's dense and kernel modes, with the drops of
``bitmap_pure`` and of compact-pure shown to occur (one subprocess,
``_torch_dist_archs_main.py 2d``)."""
import os
import subprocess
import sys
from _torch_threads import ONE_THREAD_ENV

_HERE = os.path.dirname(__file__)


def test_2d_archs_match_reference_on_2x2_and_4x4_meshes():
    env = dict(os.environ, **ONE_THREAD_ENV)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable,
                          os.path.join(_HERE, "_torch_dist_archs_main.py"),
                          "2d"], capture_output=True, text=True, timeout=900,
                         env=env)
    assert out.returncode == 0, f"{out.stdout}\n{out.stderr}"
    assert "OK torch-dist-archs 2d" in out.stdout
