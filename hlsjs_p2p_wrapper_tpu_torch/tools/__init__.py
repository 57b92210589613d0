"""The port's command-line tools, the counterparts of the reference's
``tools/sweep.py``, ``tools/policy_ab.py``, ``tools/optimize.py``,
``tools/warmstart_gate.py`` and ``tools/chaos_gate.py`` on the port's
dispatch (``ops/dispatch.py``).  Each runs as ``python -m
hlsjs_p2p_wrapper_tpu_torch.tools.<name>`` with the reference tool's
flags and defaults, and writes artifacts with the reference's keys and
row order.

They add one flag, ``--device`` (``cuda``, the default, or ``cpu``).
Without a card a tool run without ``--device cpu`` exits with a message
before any work; it never falls back to the CPU.

What their numbers mean on the port: ``platform`` is ``"gpu"`` on the
card (``"cpu"`` on the CPU) and ``device_kind`` the card's name; the
reference's count of XLA compiles is the port's ``CompileCounter``
(``engine/artifact_cache.py``): ``nvcc`` builds started plus CUDA-graph
captures.  The warm-start root is ``$HLSJS_P2P_TORCH_CACHE_DIR`` (else
``~/.cache/hlsjs_p2p_wrapper_tpu_torch``).
"""

from __future__ import annotations

import argparse

import torch

#: what a tool's compile count is on the port (the help text and the
#: artifacts' ``compile_groups`` / ``xla_compiles`` say it)
COMPILES_MEANING = ("nvcc builds started plus CUDA-graph captures "
                    "(engine/artifact_cache.py CompileCounter): the "
                    "port's count where the reference counts XLA "
                    "compiles")


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the simulator runs: the card (default) "
                         "or, with 'cpu', the plain PyTorch path; "
                         "without a card, 'cuda' exits with a message "
                         "(no fallback)")


def open_device(ap: argparse.ArgumentParser, name: str) -> torch.device:
    """The tool's device; without a card a ``cuda`` request ends the tool
    through ``ap.error`` (exit 2) before any work."""
    if name == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the port's tools run on the card by "
                 "default; pass --device cpu to run the plain PyTorch "
                 "path on the CPU")
    return torch.device(name)


def device_identity(dev: torch.device):
    """``(platform, device_kind)`` for an artifact's meta: ``("gpu",
    the card's name)`` or ``("cpu", "cpu")``."""
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev)
    return "cpu", "cpu"
