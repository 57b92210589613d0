# A copy of the reference's core/gridjoin.py (hlsjs_p2p_wrapper_tpu/core/gridjoin.py): the
# same names, formats and bytes; only the imports point at the port's own
# modules.
"""Grid joins over knob lattices: 1-D flip edges + 2-knob interactions.

The ONE implementation of the "which knob flips a point" join that
two consumers share (they are documented as the same join, so they
must literally be the same code):

- ``tools/triage_timelines.py --grid`` joins PATHOLOGY verdicts
  against a sweep's knob axes and reports which axis — or which
  PAIR of axes moving together — turns a healthy point pathological;
- ``engine/search.py``'s :class:`~..engine.search.GridRefineDriver`
  joins CONSTRAINT verdicts the same way and densifies its proposals
  around the resulting flip edges and interaction diagonals.

Both callers hand in ``points`` (dicts carrying at least the axis
keys — extra keys are ignored), the axis names, and the flagged
index set; attaching caller-specific payload (triage reasons,
refiner midpoints) happens at the call site.

Pure stdlib — the triage tool's "runs anywhere the artifact does,
no jax import" property rests on this module staying
dependency-free.
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def axis_sort_key(value):
    """Numeric-first stable ordering for mixed axis values (bools
    count as categorical, not 0/1)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return (0, value, "")
    return (1, 0, repr(value))


def grid_flips(points: Sequence[dict], axes: Sequence[str],
               flagged) -> List[dict]:
    """1-D neighbor diffs: for each axis, group the points into 1-D
    LINES (every other axis fixed), sort along the axis, and report
    each adjacent pair where exactly one point is flagged — the axis
    step that crossed the phase boundary holding everything else
    fixed."""
    flagged = set(flagged)
    flips = []
    for axis in axes:
        lines: Dict[tuple, list] = {}
        for idx, point in enumerate(points):
            rest = tuple(sorted((k, repr(point[k]))
                                for k in axes if k != axis))
            lines.setdefault(rest, []).append(idx)
        for idxs in lines.values():
            idxs = sorted(idxs,
                          key=lambda i: axis_sort_key(points[i][axis]))
            for a, b in zip(idxs, idxs[1:]):
                if (a in flagged) == (b in flagged):
                    continue
                healthy, sick = (a, b) if b in flagged else (b, a)
                flips.append({"axis": axis,
                              "healthy_point": healthy,
                              "flagged_point": sick,
                              "healthy_value": points[healthy][axis],
                              "flagged_value": points[sick][axis]})
    return flips


def grid_interactions(points: Sequence[dict], axes: Sequence[str],
                      flagged) -> List[dict]:
    """Two-knob INTERACTION flips: 2×2 blocks (both axes stepped one
    adjacent value, every other axis fixed) where ONLY one corner is
    flagged — each single-knob move from the flagged corner's
    diagonal base stays healthy, so no 1-D neighbor diff can
    attribute the flip.  The AND-shaped pathology."""
    flagged = set(flagged)
    out = []
    axes = list(axes)
    for ai, a in enumerate(axes):
        for b in axes[ai + 1:]:
            planes: Dict[tuple, dict] = {}
            for idx, point in enumerate(points):
                rest = tuple(sorted((k, repr(point[k]))
                                    for k in axes if k not in (a, b)))
                plane = planes.setdefault(
                    rest, {"cells": {}, "a": {}, "b": {}})
                ra, rb = repr(point[a]), repr(point[b])
                plane["cells"][(ra, rb)] = idx
                plane["a"][ra] = point[a]
                plane["b"][rb] = point[b]
            for plane in planes.values():
                cells = plane["cells"]
                a_vals = sorted(plane["a"],
                                key=lambda r: axis_sort_key(
                                    plane["a"][r]))
                b_vals = sorted(plane["b"],
                                key=lambda r: axis_sort_key(
                                    plane["b"][r]))
                for av0, av1 in zip(a_vals, a_vals[1:]):
                    for bv0, bv1 in zip(b_vals, b_vals[1:]):
                        corners = [cells.get((av, bv))
                                   for av in (av0, av1)
                                   for bv in (bv0, bv1)]
                        if any(c is None for c in corners):
                            continue
                        p00, p01, p10, p11 = corners
                        bad = [c for c in corners if c in flagged]
                        if len(bad) != 1:
                            continue
                        # the flagged corner's diagonal opposite is
                        # the healthy base: each single-knob step
                        # from it stays healthy, only the two-knob
                        # move flips
                        sick = bad[0]
                        base = {p00: p11, p01: p10,
                                p10: p01, p11: p00}[sick]
                        out.append({
                            "axes": [a, b],
                            "base_point": base,
                            "flagged_point": sick,
                            "base_values": [points[base][a],
                                            points[base][b]],
                            "flagged_values": [points[sick][a],
                                               points[sick][b]],
                        })
    return out
