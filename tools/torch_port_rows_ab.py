"""Hold this checkout's metrics-timeline rows to another checkout's, to the
bit, on the card.

Runs the sweep path twice, each in a process of its own that imports the
port from one checkout and builds that checkout's kernels: four lanes of
the VOD grid (``sample_grid(vod_grid(), 4)``) at 1,048,576 peers × 128
segments, a row every 40 steps, without the stall digest and with it;
and the random half of ``tools/policy_ab.py`` (its 20 cells on the random
mesh, the general path's gather kernels) at 262,144 peers under each
holder policy, the whole 960-step watch window.  Then it compares the
offload series, the timelines and the final ratios of the two checkouts
bit for bit and prints one JSON line.  A timeline
without cohort columns is TK5's instantiation without cohorts, so equal
rows show that a change to TK5's cohort instantiation left it as it was.

Run on the card, from the root of a checkout:
``python3 tools/torch_port_rows_ab.py --other PARENT_CHECKOUT [--steps
240]`` (exit 1 if any array differs).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEERS, SEGMENTS, RECORD_EVERY, LANES = 1_048_576, 128, 40, 4
#: the random half's size, the one a user runs on this card
RANDOM_PEERS = 262_144


def child(root: str, out: str, steps: int) -> None:
    """The runs of the checkout at ``root``, saved to ``out``."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from hlsjs_p2p_wrapper_tpu_torch import policy_grid as pg
    from hlsjs_p2p_wrapper_tpu_torch import sweep_grid as sg
    from hlsjs_p2p_wrapper_tpu_torch.ops import swarm_sim as sim

    config = sg.build_config(PEERS, SEGMENTS, False, 8)
    watch_s = steps * config.dt_ms / 1000.0
    built = [sg.build_scenario(config, k, watch_s=watch_s, stagger_s=60.0,
                               seed=0, device="cuda")
             for k in sg.sample_grid(sg.vod_grid(), LANES)]
    scenario = sim.stack_pytrees([sc for sc, _ in built])
    joins = torch.stack([j for _, j in built])
    arrays = {}
    for digest in (False, True):
        cfg = config._replace(stall_digest=digest)
        final, series, tl = sim.run_swarm_batch(
            cfg, scenario, sim.init_swarm(cfg, device="cuda", batch=LANES),
            steps, record_every=RECORD_EVERY)
        arrays[f"series_{digest}"] = series.cpu().numpy()
        arrays[f"timeline_{digest}"] = tl.cpu().numpy()
        arrays[f"offload_{digest}"] = sim.offload_ratio_batch(
            final).cpu().numpy()
        arrays[f"rebuffer_{digest}"] = sim.rebuffer_ratio_batch(
            final, watch_s, joins).cpu().numpy()
    mesh = pg.random_topology(RANDOM_PEERS, pg.SEED, device="cuda")
    audience = pg.build_audience(RANDOM_PEERS, pg.SEED, device="cuda")
    for policy in pg.POLICIES:
        config = pg.random_config(RANDOM_PEERS, policy=policy)
        built = [pg.build_cell_scenario(config, audience,
                                        uplink_bps=up * 1e6, pattern=pattern,
                                        wave=wave, watch_s=pg.WATCH_S,
                                        neighbors=mesh)
                 for pattern, wave, up in pg.cells()]
        scenario = sim.stack_pytrees([sc for sc, _ in built])
        joins = torch.stack([j for _, j in built])
        B = len(built)
        final, series, tl = sim.run_swarm_batch(
            config, scenario,
            sim.init_swarm(config, mesh.shape[-1], device="cuda", batch=B),
            int(pg.WATCH_S * 1000.0 / config.dt_ms),
            record_every=RECORD_EVERY)
        arrays[f"random_{policy}_series"] = series.cpu().numpy()
        arrays[f"random_{policy}_timeline"] = tl.cpu().numpy()
        arrays[f"random_{policy}_offload"] = sim.offload_ratio_batch(
            final).cpu().numpy()
        arrays[f"random_{policy}_rebuffer"] = sim.rebuffer_ratio_batch(
            final, pg.WATCH_S, joins).cpu().numpy()
        del final, series, tl, scenario
    np.savez(out, **arrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--child", nargs=2, metavar=("ROOT", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child[0], args.child[1], args.steps)
        return 0
    import numpy as np
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, root in (("this", ROOT),
                           ("other", os.path.abspath(args.other))):
            out = os.path.join(tmp, f"{name}.npz")
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--steps", str(args.steps), "--child", root,
                            out], check=True, cwd=root)
            runs[name] = dict(np.load(out))
    differ = sorted(k for k in runs["this"]
                    if not np.array_equal(runs["this"][k].view(np.uint32),
                                          runs["other"][k].view(np.uint32)))
    print(json.dumps({"lanes": LANES, "peers": PEERS, "steps": args.steps,
                      "arrays": sorted(runs["this"]), "differ": differ,
                      "equal": not differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
