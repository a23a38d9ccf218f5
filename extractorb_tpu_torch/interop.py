"""numpy <-> port conversions of the state a tracking step carries, and
of the map state (``SLAMMap`` / ``KeyFrame``) and of a vocabulary.

With these, the JAX package and the port can be fed byte-identical state:
the caller builds numpy arrays once and hands them to both.  The map
conversions read any object with the map's attributes, so a JAX map
(whose keyframe features are JAX arrays, read with ``np.asarray``) can be
carried into the port without this module importing jax.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .frontend.extractor import Features
from .slam.map import KeyFrame, SLAMMap
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
    the features of a FusedOut come as ``feats.<field>``, and the stereo
    fields of a mono step (None) are left out."""
    if isinstance(out, Features):
        return {k: getattr(out, k).cpu().numpy() for k in _FEATURE_DTYPES}
    res = {}
    for k, v in out._asdict().items():
        if isinstance(v, Features):
            res.update({f"feats.{f}": a for f, a in to_numpy(v).items()})
        elif v is not None:
            res[k] = v.cpu().numpy()
    return res


# ------------------------------------------------------------ map state

_KF_ARRAYS = ("R", "t", "xy_un", "octave", "angle", "desc", "valid", "kp_mp")
_KF_OPTIONAL = ("ur", "depth")  # stereo/RGB-D keyframes only; None for mono
_KF_SCALARS = ("kid", "frame_id", "timestamp", "is_bad", "parent")
_MAP_ARRAYS = ("mp_pos", "mp_desc", "mp_normal", "mp_max_dist", "mp_valid", "mp_first_kf",
               "mp_visible", "mp_found")
_MAP_SCALARS = ("mid", "scale_factor", "_next_kf", "_next_mp", "version")


def keyframe_to_numpy(kf) -> Dict:
    """A keyframe's state as numpy arrays and Python scalars (a JAX or a
    port ``KeyFrame``); its features under ``feats`` as a dict."""
    d = {k: np.array(getattr(kf, k)) for k in _KF_ARRAYS}
    d.update({k: None if getattr(kf, k) is None else np.array(getattr(kf, k))
              for k in _KF_OPTIONAL})
    d.update({k: getattr(kf, k) for k in _KF_SCALARS})
    d["loop_edges"] = list(kf.loop_edges)
    d["feats"] = {k: np.array(getattr(kf.feats, k)) for k in _FEATURE_DTYPES}
    return d


def keyframe_from_numpy(d: Mapping, device) -> KeyFrame:
    """The port's ``KeyFrame`` from ``keyframe_to_numpy`` state (features
    on ``device``)."""
    kf = KeyFrame(feats=features_from_numpy(d["feats"], device),
                  **{k: np.array(d[k]) for k in _KF_ARRAYS},
                  **{k: None if d.get(k) is None else np.array(d[k]) for k in _KF_OPTIONAL},
                  **{k: d[k] for k in _KF_SCALARS})
    kf.loop_edges = list(d["loop_edges"])
    return kf


def map_to_numpy(mp) -> Dict:
    """A map's state (a JAX or a port ``SLAMMap``) as numpy arrays, Python
    scalars and dicts; keyframes as ``keyframe_to_numpy`` dicts."""
    d = {k: np.array(getattr(mp, k)) for k in _MAP_ARRAYS}
    d.update({k: getattr(mp, k) for k in _MAP_SCALARS})
    d["obs"] = {int(m): {int(k): int(kp) for k, kp in o.items()} for m, o in mp.obs.items()}
    d["dead_kfs"] = {int(k): (int(p), np.array(R), np.array(t))
                     for k, (p, R, t) in mp.dead_kfs.items()}
    d["keyframes"] = {int(k): keyframe_to_numpy(kf) for k, kf in mp.keyframes.items()}
    return d


def map_from_numpy(d: Mapping, device) -> SLAMMap:
    """The port's ``SLAMMap`` from ``map_to_numpy`` state."""
    mp = SLAMMap(capacity=len(d["mp_valid"]), scale_factor=d["scale_factor"])
    for k in _MAP_ARRAYS:
        setattr(mp, k, np.array(d[k]))
    for k in _MAP_SCALARS:
        setattr(mp, k, d[k])
    mp.obs = {m: dict(o) for m, o in d["obs"].items()}
    mp.dead_kfs = {k: (p, np.array(R), np.array(t)) for k, (p, R, t) in d["dead_kfs"].items()}
    mp.keyframes = {k: keyframe_from_numpy(kd, device) for k, kd in d["keyframes"].items()}
    return mp



def vocab_to_numpy(voc) -> Dict:
    """A vocabulary's tree and weights (a JAX or a port ``Vocabulary``) as
    numpy arrays and Python scalars."""
    return {"k": int(voc.k), "L": int(voc.L),
            "children_desc": [np.array(d, np.uint8) for d in voc.children_desc],
            "children_id": [np.array(i, np.int64) for i in voc.children_id],
            "weights": np.array(voc.weights)}


def vocab_from_numpy(d: Mapping):
    """The port's ``Vocabulary`` from ``vocab_to_numpy`` state."""
    from .place.vocab import Vocabulary

    return Vocabulary(d["k"], d["L"], [np.array(a) for a in d["children_desc"]],
                      [np.array(a) for a in d["children_id"]], np.array(d["weights"]))
