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
print(" ".join(names))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", PROBE, ROOT],
                         capture_output=True, text=True, env=env,
                         cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    counts, names = out.stdout.splitlines()
    n_modules, bad = counts.split()[0], counts.split()[1:]
    assert int(n_modules) >= 14   # core, engine, ops, testing and theirs
    assert bad == [], f"the port loaded {bad}"
    for name in ("sweep_grid", "policy_grid", "engine.digest",
                 "engine.faults", "engine.telemetry", "ops.dispatch",
                 "ops.swarm_kernels", "engine.controller",
                 "engine.twinframe", "engine.slo", "engine.protocol",
                 "core.segment_view", "core.track_view", "testing.twin",
                 "testing.control_fixture", "testing.tools_fixture",
                 "tools.sweep", "tools.policy_ab", "tools.optimize",
                 "tools.warmstart_gate", "tools.chaos_gate",
                 "tools.fleet_gate", "tools.trace_gate",
                 "tools.optimize_gate", "tools.population_gate",
                 "tools.trace_export", "tools.fleet_console",
                 "version", "core.clock", "core.errors", "core.events",
                 "core.media_map", "core.request_setup",
                 "core.player_interface", "core.loader", "core.session",
                 "core.wrapper", "core.abr", "engine.cache", "engine.cdn",
                 "engine.stats", "engine.cdn_agent", "engine.scheduler",
                 "engine.transport", "engine.mesh", "engine.p2p_agent",
                 "engine.tracker", "engine.netfaults", "engine.net",
                 "player.manifest", "player.sim", "testing.mock_cdn",
                 "testing.fixtures", "testing.seed_process",
                 "testing.swarm", "tools.control", "tools.twin_gate",
                 "tools.control_gate"):
        assert f"hlsjs_p2p_wrapper_tpu_torch.{name}" in names.split()
