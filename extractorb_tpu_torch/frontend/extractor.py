"""End-to-end ORB extraction, device-octree path
(port of ``extractorb_tpu/frontend/extractor.py``).

pyramid -> FAST with cells and retry (K1, all levels in one launch) ->
per-level top-K collection, quadtree distribution and compaction (plain
torch) -> orientation + blur + rotated BRIEF (K2, all levels in one
launch) -> merge into one fixed-capacity ``Features``, keypoints scaled to
level-0 coordinates.  Nothing in a frame synchronises with the host.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import ORBConfig
from . import fast as ffast
from .brief import DescribePlan, orb_describe
from .octree import OctreePlan, distribute_device
from .pyramid import Pyramid, PyramidPlan, compute_pyramid


@dataclasses.dataclass(frozen=True)
class Features:
    """Padded per-image feature set, in the JAX package's layout."""

    xy: torch.Tensor        # (N, 2) float32, level-0 coordinates
    response: torch.Tensor  # (N,) float32
    angle: torch.Tensor     # (N,) float32 degrees
    octave: torch.Tensor    # (N,) int32
    size: torch.Tensor      # (N,) float32 (scaled patch size)
    desc: torch.Tensor      # (N, 32) uint8 packed 256-bit descriptors
    valid: torch.Tensor     # (N,) bool


def scale_factors(cfg: ORBConfig) -> np.ndarray:
    """float32 cumulative scale factors, like the reference ctor
    (mvScaleFactor[i] = mvScaleFactor[i-1]*scaleFactor in float)."""
    s = np.empty(cfg.n_levels, np.float32)
    s[0] = 1.0
    for i in range(1, cfg.n_levels):
        s[i] = np.float32(s[i - 1] * np.float32(cfg.scale_factor))
    return s


def _compact(xy, resp, mask, capacity: int):
    """Select the best `capacity` masked keypoints (response-major,
    earlier-index tiebreak) into a fixed-size buffer.  Masked keys are
    unique; the -1 keys of unmasked slots tie, but those slots come out
    zeroed whatever their order."""
    n = mask.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    key = torch.where(mask, resp * n - idx, -1)
    top, order = torch.topk(key, capacity)
    valid = top >= 0
    xy_o = torch.where(valid[:, None], xy[order], 0)
    resp_o = torch.where(valid, resp[order], 0)
    return xy_o, resp_o, valid


def _truncate(feats: Features, capacity: int) -> Features:
    """Front-pack valid features into a fixed-capacity Features,
    preserving level order (the reference's per-level concatenation)."""
    n = feats.valid.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=feats.valid.device)
    key = torch.where(feats.valid, idx, n + idx)  # unique
    skey, order = torch.sort(key)
    order, valid = order[:capacity], skey[:capacity] < n
    take = lambda a: a[order]
    v1 = valid[:, None]
    return Features(
        xy=torch.where(v1, take(feats.xy), 0.0),
        response=torch.where(valid, take(feats.response), 0.0),
        angle=torch.where(valid, take(feats.angle), 0.0),
        octave=torch.where(valid, take(feats.octave), -1),
        size=torch.where(valid, take(feats.size), 0.0),
        desc=torch.where(v1, take(feats.desc), 0),
        valid=valid,
    )


class ORBExtractor:
    """ORB extraction for one image shape on one device.  The static
    tables of the pyramid, FAST cells, quadtrees and descriptor kernel are
    built once, in the constructor."""

    def __init__(self, cfg: ORBConfig, img_shape, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.scales = scale_factors(cfg)
        self._scales_t = torch.as_tensor(self.scales, device=self.device)
        self.budgets = cfg.features_per_level
        # the merged feature capacity: n_features plus 16 spare per level
        self.capacity = cfg.n_features + cfg.n_levels * 16
        h0, w0 = img_shape
        self.pyr_plan = PyramidPlan(w0, h0, cfg.n_levels, cfg.scale_factor, self.device)
        self.fast_plan = ffast.FastPlan(self.pyr_plan.shapes, self.pyr_plan.offsets)
        self.desc_plan = DescribePlan(self.pyr_plan.shapes, self.pyr_plan.offsets, self.device)
        min_b = ffast.MIN_BORDER
        self.levels = []
        for lvl, (w, h) in enumerate(self.pyr_plan.sizes):
            # candidate capacity scales with level area (as the JAX package)
            k_lvl = min(cfg.max_kps_per_level, max(512, -(-(h * w) // 75 // 512) * 512))
            cap_l = min(cfg.max_kps_per_level, self.budgets[lvl] + 16, k_lvl)
            octree = OctreePlan(w - 2 * min_b, h - 2 * min_b, min_b, min_b, self.device)
            self.levels.append((k_lvl, cap_l, octree))
        self._level_ids = torch.cat([
            torch.full((cap_l,), lvl, dtype=torch.int32, device=self.device)
            for lvl, (_, cap_l, _) in enumerate(self.levels)])

    def __call__(self, img: torch.Tensor) -> Features:
        """Extract ORB features from a uint8 grayscale image (H, W) on
        this extractor's device, into ``self.capacity`` slots."""
        return self.extract_with_pyramid(img)[0]

    def extract_with_pyramid(self, img: torch.Tensor) -> Tuple[Features, Pyramid]:
        """``__call__`` that also returns the bordered pyramid it built
        (levels laid out by ``self.pyr_plan``), so that the stereo match
        reads it instead of building it again."""
        pyr = compute_pyramid(img.to(self.device), self.pyr_plan)
        xy, resp, valid, level = self.keypoints(pyr)
        angle, desc = orb_describe(pyr, self.desc_plan, xy, level, valid)
        return self._merge(xy, resp, valid, level, angle, desc), pyr

    def keypoints(self, pyr):
        """FAST, per-level top-K, quadtree and compaction: the keypoints of
        every level, concatenated (xy int32 inner coords of their level,
        response, valid, level)."""
        cfg = self.cfg
        keeps, scores = ffast.fast_detect(pyr, self.fast_plan, cfg.ini_th_fast, cfg.min_th_fast)
        xys, resps, valids = [], [], []
        for lvl, (k_lvl, cap_l, octree) in enumerate(self.levels):
            xy_all, resp_all, valid_all = ffast.collect_keypoints(keeps[lvl], scores[lvl], k_lvl)
            sel, _ = distribute_device(xy_all, resp_all, valid_all, self.budgets[lvl], octree)
            xy, resp, valid = _compact(xy_all, resp_all, valid_all & sel, cap_l)
            xys.append(xy)
            resps.append(resp)
            valids.append(valid)
        return torch.cat(xys), torch.cat(resps), torch.cat(valids), self._level_ids

    def _merge(self, xy, resp, valid, level, angle, desc) -> Features:
        scales = self._scales_t[level]
        feats = Features(
            xy=xy.to(torch.float32) * scales[:, None],
            response=resp.to(torch.float32),
            angle=angle,
            octave=level,
            size=31.0 * scales,
            desc=desc,
            valid=valid,
        )
        return _truncate(feats, self.capacity)
