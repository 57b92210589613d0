"""The port's policy search (``engine/search.py``, ``core/gridjoin.py``,
``search_eval.py``) against the reference's ``engine/search.py``,
``core/gridjoin.py`` and ``tools/optimize.py``: the four drivers (and the
exhaustive grid) propose the same points to the bit from the same seed
and the same tells, their checkpoints are byte-equal, a resumed search
gives the uninterrupted frontier, the grid joins agree, and
``search_eval.Evaluator`` on three live-lattice points at a tiny size
gives the reference's rows (the reference's dispatch without its warm
start) within 1e-4, with the same feasibility labels."""

import json
import os
import sys

import pytest

from hlsjs_p2p_wrapper_tpu.core import gridjoin as ref_gridjoin
from hlsjs_p2p_wrapper_tpu.engine import search as ref_search
from hlsjs_p2p_wrapper_tpu_torch import search_eval
from hlsjs_p2p_wrapper_tpu_torch.core import gridjoin as port_gridjoin
from hlsjs_p2p_wrapper_tpu_torch.engine import search as port_search
from hlsjs_p2p_wrapper_tpu_torch.engine.telemetry import MetricsRegistry

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import optimize as ref_optimize  # noqa: E402

DRIVERS = ("random", "halving", "cmaes", "refine", "grid")


def _space(mod):
    return mod.SearchSpace(
        continuous=(mod.ContinuousAxis("x", 0.0, 1.0),
                    mod.ContinuousAxis("y", 0.0, 2.0),
                    mod.ContinuousAxis("z", -1.0, 1.0)),
        categorical=(mod.CategoricalAxis("mode", ("a", "b", "c")),),
        fixed={"degree": 8})


def _lattice():
    return [{"x": x, "y": y, "z": 0.0, "mode": m}
            for x in (0.0, 0.5, 1.0) for y in (0.0, 2.0)
            for m in (0, 1)]


def _driver(mod, name, space, constraint):
    if name == "random":
        return mod.RandomDriver(space, 3)
    if name == "halving":
        return mod.HalvingDriver(space, 3, initial=_lattice(), rungs=3,
                                 eta=2.0, constraint=constraint)
    if name == "cmaes":
        return mod.CmaEsDriver(space, 3, popsize=6, sigma0=0.3,
                               pins={"mode": 1}, constraint=constraint)
    if name == "refine":
        return mod.GridRefineDriver(space, 3, initial=_lattice(),
                                    max_per_round=8)
    return mod.GridDriver(space, 3, initial=_lattice())


def _evaluate(space):
    """A closed-form evaluator: offload a smooth bowl of the knobs,
    rebuffer over the bound where x and y are both high (an AND-shaped
    infeasible corner) or the fidelity is short."""
    def evaluate(proposals, round_index):
        out = []
        for prop in proposals:
            k = space.materialize(prop["point"])
            off = (1.0 - (k["x"] - 0.6) ** 2 - (k["y"] / 2.0 - 0.4) ** 2
                   - 0.1 * k["z"] ** 2 + 0.01 * ("abc".index(k["mode"])))
            reb = (0.05 if k["x"] > 0.7 and k["y"] > 1.2 else 0.001
                   * k["y"]) + 0.002 * (1.0 - prop["fidelity"])
            out.append({"point": dict(prop["point"]),
                        "fidelity": prop["fidelity"], "knobs": k,
                        "offload": float(off), "rebuffer": float(reb),
                        "failed": False, "cached": round_index % 2 == 1})
        return out
    return evaluate


def _search(mod, name, path, budget=40.0, registry=None):
    space = _space(mod)
    constraint = mod.Constraint.parse("rebuffer<=0.02")
    return mod.PolicySearch(
        _driver(mod, name, space, constraint), _evaluate(space),
        constraint, budget=budget, batch=8, registry=registry,
        checkpoint_path=path, checkpoint_meta={"driver": name, "seed": 3})


@pytest.mark.parametrize("name", DRIVERS)
def test_drivers_and_checkpoints_equal_the_reference(tmp_path, name):
    """Round by round, the port's driver proposes what the reference's
    does (the trials of each round, floats by ``repr``), and the
    checkpoint written after each round is byte-equal; the results and
    the frontier agree."""
    ref_s = _search(ref_search, name, str(tmp_path / "ref.json"))
    port_s = _search(port_search, name, str(tmp_path / "port.json"),
                     registry=MetricsRegistry())
    rounds = 0
    while not ref_s.driver.done and ref_s.spent < ref_s.budget - 1e-9:
        want = ref_s.driver.ask(ref_s.batch)
        got = port_s.driver.ask(port_s.batch)
        assert json.dumps(got) == json.dumps(want)
        if not want:
            break
        for s, asked in ((ref_s, want), (port_s, got)):
            trials = s.evaluate(s._trim_to_budget(asked), s.round)
            for t in trials:
                t["round"] = s.round
                t["feasible"] = s.constraint.feasible(t)
            s.driver.tell(trials)
            s.trials.extend(trials)
            s.spent += sum(float(t["fidelity"]) for t in trials)
            s.round += 1
            s.checkpoint()
        with open(tmp_path / "ref.json", "rb") as a, \
                open(tmp_path / "port.json", "rb") as b:
            assert b.read() == a.read()
        rounds += 1
    assert rounds >= 2
    assert json.dumps(port_s.result()) == json.dumps(ref_s.result())
    # the whole loop, counters and per-round provenance included
    ref_r = _search(ref_search, name, str(tmp_path / "ref2.json")).run()
    port_r = _search(port_search, name, str(tmp_path / "port2.json")).run()
    assert json.dumps(port_r) == json.dumps(ref_r)
    with open(tmp_path / "ref2.json", "rb") as a, \
            open(tmp_path / "port2.json", "rb") as b:
        assert b.read() == a.read()


def test_resumed_search_gives_the_same_frontier(tmp_path):
    """A halving search stopped after its first round (its evaluator
    raises in the second) and resumed from its checkpoint gives the
    uninterrupted search's frontier and trials; the reference's
    uninterrupted search agrees; the checkpoint path is the
    reference's."""
    whole = _search(port_search, "halving", None).run()
    path = str(tmp_path / "ckpt.json")
    stopped = _search(port_search, "halving", path)
    evaluate = stopped.evaluate

    def stop_in_round_1(proposals, round_index):
        if round_index == 1:
            raise KeyboardInterrupt
        return evaluate(proposals, round_index)
    stopped.evaluate = stop_in_round_1
    with pytest.raises(KeyboardInterrupt):
        stopped.run()
    resumed = _search(port_search, "halving", path)
    assert resumed.resume() and resumed.round == 1
    result = resumed.run()
    assert json.dumps(result["frontier"]) == json.dumps(whole["frontier"])
    assert json.dumps(result["trials"]) == json.dumps(whole["trials"])
    ref_whole = _search(ref_search, "halving", None).run()
    assert json.dumps(ref_whole["frontier"]) == json.dumps(whole["frontier"])
    meta = {"tool": "optimize", "seed": 3}
    assert port_search.search_checkpoint_path("/c", meta) == \
        ref_search.search_checkpoint_path("/c", meta)


def test_grid_joins_equal_the_reference():
    points = [{"a": a, "b": b, "c": c} for a in (0.0, 1.0, 2.0)
              for b in ("lo", "hi") for c in (1, 2, 3)]
    flagged = {i for i, p in enumerate(points)
               if (p["a"] >= 1.0 and p["b"] == "hi") or p["c"] == 3}
    axes = ["a", "b", "c"]
    assert port_gridjoin.grid_flips(points, axes, flagged) == \
        ref_gridjoin.grid_flips(points, axes, flagged)
    assert port_gridjoin.grid_interactions(points, axes, flagged) == \
        ref_gridjoin.grid_interactions(points, axes, flagged)
    assert port_search.grid_flips is port_gridjoin.grid_flips


def test_live_space_meta_and_drivers_equal_the_tool():
    """``search_eval``'s space, lattice, meta and drivers are
    ``tools/optimize.py``'s: the same materialized lattice (the live
    grid), the same meta digest inputs, the same first proposals."""
    space, ref_space = search_eval.live_space(), ref_optimize.live_space()
    assert search_eval.live_lattice() == ref_optimize.live_lattice()
    assert [space.materialize(p) for p in search_eval.live_lattice()] == \
        [ref_space.materialize(p) for p in ref_optimize.live_lattice()]
    args = search_eval.search_args(peers=48)
    ref_args = ref_optimize.build_parser().parse_args(["--peers", "48"])
    assert vars(args) == {k: v for k, v in vars(ref_args).items()
                          if k in vars(args)}
    constraint = port_search.Constraint.parse(args.constraint)
    ref_constraint = ref_search.Constraint.parse(args.constraint)
    assert search_eval.search_meta(args, space, constraint) == \
        ref_optimize.search_meta(ref_args, ref_space, ref_constraint)
    for name in ("halving", "random", "refine", "grid", "cmaes"):
        args.driver = ref_args.driver = name
        got = search_eval.build_driver(args, space, constraint).ask(144)
        want = ref_optimize.build_driver(ref_args, ref_space,
                                         ref_constraint).ask(144)
        assert json.dumps(got) == json.dumps(want)
    assert search_eval.TRIAL_METRICS == ref_optimize.TRIAL_METRICS


def test_evaluator_rows_match_the_reference():
    """Three live-lattice points at 48 peers x 32 segments, a 60-s
    watch, screened at a quarter and run whole: the port's
    ``Evaluator`` (the port's dispatch, on the CPU) against the tool's
    (the reference's dispatch, no warm start): offload and rebuffer
    within 1e-4 and the same feasibility under ``rebuffer<=0.02`` and
    under ``rebuffer<=0.005``, which splits them."""
    lattice = search_eval.live_lattice()
    points = [lattice[i] for i in (1, 33, 104)]
    proposals = [{"point": p, "fidelity": f} for f in (1.0, 0.25)
                 for p in points]
    common = dict(peers=48, segments=32, watch_s=60.0, seed=0, chunk=3,
                  faults=None, journal=None, stagger_s=5.0)
    got = search_eval.Evaluator(search_eval.live_space(), warm_start=None,
                                device="cpu", **common)(proposals, 0)
    want = ref_optimize.Evaluator(ref_optimize.live_space(),
                                  warm_start=None, **common)(proposals, 0)
    bounds = [port_search.Constraint.parse(f"rebuffer<={b}")
              for b in ("0.02", "0.005")]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g["point"] == w["point"] and g["knobs"] == w["knobs"]
        assert g["fidelity"] == w["fidelity"]
        assert not g["failed"] and not w["failed"] and not g["cached"]
        assert abs(g["offload"] - w["offload"]) <= 1e-4
        assert abs(g["rebuffer"] - w["rebuffer"]) <= 1e-4
        for constraint in bounds:
            assert constraint.feasible(g) == constraint.feasible(w)
    assert len({round(t["offload"], 3) for t in got}) > 3
    assert {bounds[1].feasible(t) for t in got} == {True, False}
