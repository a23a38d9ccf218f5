"""numpy <-> port conversions of the state a tracking step carries.

With these, the JAX step and the port can be fed byte-identical state:
the caller builds numpy arrays once and hands them to both.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .frontend.extractor import Features
from .slam.track_device import FusedOut, LocalBlock

_FEATURE_DTYPES = {
    "xy": torch.float32, "response": torch.float32, "angle": torch.float32,
    "octave": torch.int32, "size": torch.float32, "desc": torch.uint8, "valid": torch.bool,
}


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)


def features_from_numpy(d: Mapping[str, np.ndarray], device) -> Features:
    """Features from a dict with the seven ``Features`` fields."""
    return Features(**{k: _t(d[k], dt, device) for k, dt in _FEATURE_DTYPES.items()})


def local_block_from_numpy(d: Mapping[str, np.ndarray], device) -> LocalBlock:
    """LocalBlock from a dict with ids, pos, desc, norm, maxd, val."""
    return LocalBlock(
        ids=_t(d["ids"], torch.int32, device), pos=_t(d["pos"], torch.float32, device),
        desc=_t(d["desc"], torch.uint8, device), norm=_t(d["norm"], torch.float32, device),
        maxd=_t(d["maxd"], torch.float32, device), val=_t(d["val"], torch.bool, device),
    )


def step_inputs_from_numpy(img, last: Mapping[str, np.ndarray], kp_mp, map_pos, map_valid,
                           local: Mapping[str, np.ndarray], ref: Mapping[str, np.ndarray],
                           R_last, t_last, R_prev, t_prev, device) -> tuple:
    """The 21 positional inputs of ``TrackStep`` from numpy arrays.

    last: the previous frame's ``xy_un`` (N,2), ``desc`` (N,32),
    ``octave`` (N,) and ``angle`` (N,); kp_mp (N,) its map-point ids;
    map_pos/map_valid the map mirror (CAP,3)/(CAP,); local the local
    block (see ``local_block_from_numpy``); ref the reference-keyframe
    block (``desc``, ``valid``, ``kp_mp``); then the last two poses."""
    f32 = lambda a: _t(a, torch.float32, device)
    i32 = lambda a: _t(a, torch.int32, device)
    blk = local_block_from_numpy(local, device)
    return (
        _t(img, torch.uint8, device),
        f32(last["xy_un"]), _t(last["desc"], torch.uint8, device), i32(last["octave"]),
        f32(last["angle"]), i32(kp_mp),
        f32(map_pos), _t(map_valid, torch.bool, device),
        blk.ids, blk.pos, blk.desc, blk.norm, blk.maxd, blk.val,
        _t(ref["desc"], torch.uint8, device), _t(ref["valid"], torch.bool, device),
        i32(ref["kp_mp"]),
        f32(R_last), f32(t_last), f32(R_prev), f32(t_prev),
    )


def to_numpy(out) -> Dict[str, np.ndarray]:
    """A ``FusedOut`` (or ``Features``) as a flat dict of numpy arrays;
    the features of a FusedOut come as ``feats.<field>``."""
    if isinstance(out, Features):
        return {k: getattr(out, k).cpu().numpy() for k in _FEATURE_DTYPES}
    res = {}
    for k, v in out._asdict().items():
        if isinstance(v, Features):
            res.update({f"feats.{f}": a for f, a in to_numpy(v).items()})
        else:
            res[k] = v.cpu().numpy()
    return res
