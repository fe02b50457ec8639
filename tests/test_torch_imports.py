"""The port stands alone: every module of ``repro_torch`` imports with
``jax`` and ``repro`` blocked, and no source line imports either."""
import os
import re
import subprocess
import sys
from pathlib import Path

_SRC = Path(__file__).resolve().parent.parent / "src"
_PKG = _SRC / "repro_torch"

_PROBE = r"""
import importlib, sys
from pathlib import Path

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
root = Path(sys.argv[1])
mods = sorted(".".join(p.relative_to(root.parent).with_suffix("").parts)
              for p in root.rglob("*.py"))
for m in mods:
    importlib.import_module(m.removesuffix(".__init__"))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")]
assert not bad, bad
print("imported", len(mods))
"""


def test_every_module_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(_SRC))
    r = subprocess.run([sys.executable, "-c", _PROBE, str(_PKG)],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 15


def test_no_source_line_imports_jax_or_repro():
    pat = re.compile(r"^\s*(import (jax|repro)\b|from (jax|repro)(\.| import))")
    roots = list(_PKG.rglob("*.py")) + [_SRC.parent / "chip_smoke.py"]
    hits = [f"{p}:{i}" for p in roots for i, line in
            enumerate(p.read_text().splitlines(), 1) if pat.match(line)]
    assert not hits, hits
