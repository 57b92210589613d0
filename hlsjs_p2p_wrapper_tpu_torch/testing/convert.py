"""Carry the simulator's state and scenario between the reference and
the port as numpy arrays keyed by field name.

The reference's ``SwarmState`` and ``SwarmScenario`` become plain
dicts of numpy arrays (the ``ewma`` fields nested as a dict); this
module turns such dicts into the port's tensors and back.  The u32
fields (``avail``, ``dl_flags``) keep their bit patterns: the port
stores them as int32 tensors with the same bits (a ``.view``).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..core.device import resolve_device
from ..ops.ewma import EwmaState
from ..ops.swarm_sim import SwarmScenario, SwarmState

#: fields that hold u32 bit patterns
U32_FIELDS = ("avail", "dl_flags")


def _tensor(value, device, u32: bool = False) -> torch.Tensor:
    arr = np.array(value, order="C")  # a writable copy; 0-dim stays 0-dim
    if u32:
        arr = arr.astype(np.uint32, copy=False).view(np.int32)
    elif arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    elif arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return torch.from_numpy(arr).to(resolve_device(device))


def state_from_numpy(fields: Mapping, device) -> SwarmState:
    """A port ``SwarmState`` from the reference's fields as numpy
    arrays (``fields["ewma"]`` a dict of the four estimator fields)."""
    ewma = fields["ewma"]
    values = {}
    for name in SwarmState._fields:
        if name == "ewma":
            values[name] = EwmaState(*(_tensor(ewma[f], device)
                                       for f in EwmaState._fields))
        else:
            values[name] = _tensor(fields[name], device,
                                   u32=name in U32_FIELDS)
    return SwarmState(**values)


def state_to_numpy(state: SwarmState) -> dict:
    """The reverse of :func:`state_from_numpy`; u32 fields come back
    as ``np.uint32``."""
    out = {}
    for name, value in state._asdict().items():
        if name == "ewma":
            out[name] = {f: t.detach().cpu().numpy()
                         for f, t in value._asdict().items()}
            continue
        arr = value.detach().cpu().numpy()
        out[name] = arr.view(np.uint32) if name in U32_FIELDS else arr
    return out


def scenario_from_numpy(fields: Mapping, device) -> SwarmScenario:
    """A port ``SwarmScenario`` from the reference's fields as numpy
    arrays (per-peer arrays and 0-dim policy scalars alike)."""
    return SwarmScenario(**{name: _tensor(fields[name], device)
                            for name in SwarmScenario._fields})
