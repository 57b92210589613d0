"""Rehearse ``chip_smoke.py`` on a machine without a card.

``python -m hlsjs_p2p_wrapper_tpu_torch.testing.rehearse`` runs every
phase of ``chip_smoke.py`` on the CPU at a small size, so that a wrong
path, shape, argument or control flow shows before a run on the card.
It executes the script's source with ``"cuda"`` replaced by ``"cpu"``,
so every wrapper takes its plain version, and stands in for what the
CPU build of PyTorch lacks:

- CUDA events (host clock), ``synchronize``, ``_sleep`` and the memory
  statistics, ``nvidia-smi`` and ``nvcc`` (the build is skipped);
- ``torch.profiler``'s CUDA activity (it traces the CPU; the device
  busy times come out as "not measured");
- the CUDA-graph capture of the scan (``torch.cuda.CUDAGraph``,
  through ``swarm_kernels.capture``): the scan takes its graph path on
  the CPU, a capture records the callable and each replay runs it;
- the launch counts: wrappers that count a launch where the kernel
  would have launched;
- the real out-of-memory phase, which needs the card's allocator, is
  skipped.

What it cannot show: that a kernel builds, runs or is right, and any
time; ``chip_smoke.py`` on the card shows those.  A check that needs
the real size (the stalling points of the 48-point grid), or the
kernels' own summation order (the bits of ``lane_sums_in_order``), is
reported and does not stop the rehearsal.  Takes ~30 minutes on a
CPU.
"""

from __future__ import annotations

import functools
import os
import sys
import time

#: the rehearsal's shapes, in place of chip_smoke.py's
SIZES = dict(CHECK_PEERS=2_048, PEERS=2_048, GRID_PEERS=2_048, STEPS=400,
             CHECK_WARM_STEPS=60, BACK_TO_BACK=3, WINDOW=10,
             SUMS_PEERS=(1_000, 1_001, 2_048), RING_PEERS=2_048,
             GENERIC_SLOTS=((2, 1_024, 20), (16, 512, 20)),
             GATHER_PEERS=2_048, RANDOM_PEERS=512,
             RANDOM_PEERS_LARGE=1_024,
             # a fabric unit takes ~10x longer on the CPU than on the card
             FLEET_LEASE_S=60.0,
             FLEET_CHAOS={"host01": "kill@1", "host02": "stall@1:120.0"},
             # phase 43's fleet and trace gates: their stall is 3 leases
             GATE_LEASE_S=40.0,
             # phase 42's tool children run on this host's CPU
             TOOL_PLATFORM="cpu")
#: checks that hold only at the real size (the stalling points of the
#: grids, the live rows against the reference's record), checks of the
#: kernels' bits (the plain versions sum by ``torch.sum``, not in their
#: order), and the card's limit on a neighbour list's width (the CPU
#: path takes any)
SIZE_BOUND_CHECKS = ("stall", "lane_sums_in_order", "grid's size",
                     "differ from the reference by", "anchored cells",
                     "HEAD's reference by", "the card's audience limit")


class EagerGraph:
    """Stands in for a captured CUDA graph: a replay runs the callable
    the capture was given."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


class _Event:
    def __init__(self, enable_timing=False):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def query(self):
        return False   # the host always stays ahead here

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def _stub_cuda(torch):
    torch.cuda.is_available = lambda: True
    torch.cuda.Event = _Event
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda._sleep = lambda n: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.get_device_name = lambda *a: "cpu rehearsal"
    torch.cuda.device_count = lambda: 0
    import torch.profiler as tp
    profile = tp.profile
    tp.profile = lambda activities=None, **k: profile(
        activities=[tp.ProfilerActivity.CPU], **k)


def _count_launches(sk):
    """Wrap each launching wrapper so that it adds one to the count of
    its kernel (``swarm_kernels.KERNEL_OF``) where that kernel would
    launch: a call that routed to another counted wrapper (``peer_update``
    on the general path) is counted there only."""
    def counted(name, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kw):
            before = sum(sk.LAUNCHES.values())
            out = fn(*args, **kw)
            if sum(sk.LAUNCHES.values()) == before:
                sk.LAUNCHES[name] += 1
            return out
        return wrapped
    for wrapper, kernel in sk.KERNEL_OF.items():
        setattr(sk, wrapper, counted(kernel, getattr(sk, wrapper)))


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    # the child processes (phases 35 and 38) share this host's cores: two
    # threads each, or six thread pools thrash them (this process keeps
    # its own count)
    torch.set_num_threads(torch.get_num_threads())
    os.environ["OMP_NUM_THREADS"] = "2"

    from ..ops import _build
    from ..ops import swarm_kernels as sk
    path = os.path.join(root, "chip_smoke.py")
    with open(path) as fh:
        source = fh.read().replace('"cuda"', '"cpu"')
    ns = {"__name__": "chip_smoke_rehearsal", "__file__": path}
    exec(compile(source, path, "exec"), ns)
    _stub_cuda(torch)
    _count_launches(sk)
    sk.graph_path = lambda dev: True
    sk.capture = lambda fn, dev, n_lanes, n_peers, pool=None: sk.Graph(
        EagerGraph(fn), {}, None)
    _build.nvcc_path = lambda: "nvcc"
    strict = ns["check"]

    def check(cond, msg):
        if not cond and any(w in msg for w in SIZE_BOUND_CHECKS):
            print(f"rehearsal: holds only on the card at the real size: "
                  f"{msg}")
            return
        strict(cond, msg)
    ns.update(SIZES, check=check,
              phase_build=lambda: print("[2] build: none on the CPU"),
              registers_of=lambda *args, **kw: "not built",
              gather_resources=lambda *args, **kw: {},
              regs_of_entry=lambda *args, **kw: "not built",
              phase_real_oom=lambda *a: print(
                  "[20] a real CUDA OOM: needs the card"),
              run_cmd=lambda cmd, timeout=120: "cpu rehearsal, 0 W")
    t0 = time.perf_counter()
    rc = ns["main"]()
    print(f"rehearsal: exit {rc} after {time.perf_counter() - t0:.0f} s")
    return rc


if __name__ == "__main__":
    sys.exit(main())
