"""The PyTorch port stands alone: importing every module of
``hlsjs_p2p_wrapper_tpu_torch`` (and ``chip_smoke.py``) in a fresh
process loads neither ``jax`` nor the reference package."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import hlsjs_p2p_wrapper_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "hlsjs_p2p_wrapper_tpu")
             or m.startswith(("jax.", "jaxlib.", "hlsjs_p2p_wrapper_tpu.")))
print(len(names), ",".join(bad))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT],
                         capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split()[0], out.stdout.split()[1:]
    assert int(n_modules) >= 8   # core, ops, testing and their modules
    assert bad == [], f"the port loaded {bad}"
