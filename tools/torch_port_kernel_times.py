"""Time the port's step kernels and their plain versions with CUDA events
at the sweep path's shapes, on the card.

For each lane batch that PERF.md's kernel table lists beside the main
path (the 48-point VOD grid at 1,048,576 peers, the live grid's first 64
points, the 20-lane ring chunk of ``tools/policy_ab.py`` under each of
the three holder policies), the lanes run from the start as replayed
CUDA graphs for the watch window's 960 steps, as ``chip_smoke.py``'s
direct runs do.  From that final state, ``chip_smoke.time_window`` times
eager steps between CUDA events on four routes: the main path
(``select_admit``, ``peer_update``), TK1 + TK2 then ``peer_update``, and
the plain versions of each (``plain``, ``plain_pair``).  One JSON line
per batch, after the card's name and power limit.

Run on the card from the root of a checkout:
``python3 tools/torch_port_kernel_times.py``.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: eager steps timed on the kernels' routes (halved, down to
#: MIN_WINDOW, while the host fails to queue a window within the GPU
#: sleep that ``time_window`` puts ahead of it), and on the plain route
WINDOW = 40
MIN_WINDOW = 10
PLAIN_STEPS = 3


def batches(cs, sim, sg, pg):
    """``(label, config, stacked scenarios)`` of each batch, built on the
    card when its turn comes."""
    def grid(live, n):
        config = sg.build_config(cs.GRID_PEERS, cs.GRID_SEGMENTS, live, 8)
        points = (sg.live_grid() if live else sg.vod_grid())[:n]
        built = [sg.build_scenario(config, k, watch_s=cs.GRID_WATCH_S,
                                   stagger_s=cs.GRID_STAGGER_S, seed=0,
                                   device="cuda") for k in points]
        return config, sim.stack_pytrees([sc for sc, _ in built])

    def ring(policy):
        config = pg.ring_config(cs.RING_PEERS, policy=policy)
        audience = pg.build_audience(config.n_peers, pg.SEED, device="cuda")
        built = [pg.build_cell_scenario(config, audience,
                                        uplink_bps=up * 1e6, pattern=pattern,
                                        wave=wave, watch_s=pg.WATCH_S)
                 for pattern, wave, up in pg.cells()]
        return config, sim.stack_pytrees([sc for sc, _ in built])

    yield ("VOD grid, 48 lanes", lambda: grid(False, 48))
    yield (f"live grid, first {cs.LIVE_TRACE_LANES} points",
           lambda: grid(True, cs.LIVE_TRACE_LANES))
    for policy in ("spread", "adaptive", "ranked"):
        yield f"ring {policy} grid, 20 lanes", lambda p=policy: ring(p)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_port_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
    from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_kernels as sk
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as sim
    print(cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"]), flush=True)
    sk.build_kernels()
    for label, make in batches(cs, sim, sg, pg):
        config, scenario = make()
        B = scenario.join_s.shape[0]
        n_steps = int(cs.GRID_WATCH_S * 1000.0 / config.dt_ms)
        init = sim.init_swarm(config, device="cuda", batch=B)
        wall, _cap, (final, _series) = cs.timed_run(
            sim, sk, config, scenario, init, n_steps, "graph")
        del init, _series
        out = {"batch": label, "lanes": B, "peers": config.n_peers,
               "slots": config.max_concurrency,
               "policy": config.holder_selection, "live": config.live,
               "run_s": wall}
        for route in ("fused", "pair", "plain", "plain_pair"):
            steps = PLAIN_STEPS if route.startswith("plain") else WINDOW
            while True:
                try:
                    per_pass, _step = cs.time_window(
                        sim, sk, config, scenario, final, steps, route)
                    break
                except cs.SmokeFailure:
                    if steps // 2 < MIN_WINDOW:
                        raise
                    steps //= 2
            out[route] = per_pass
            out[f"{route}_steps"] = steps
        print(json.dumps(out), flush=True)
        del final, scenario
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
