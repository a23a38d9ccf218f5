"""End-to-end ORB extraction, device-octree path
(port of ``extractorb_tpu/frontend/extractor.py``).

pyramid (K15) -> FAST with cells and retry (K1, all levels in one
launch) -> per-level top-K collection (K16, one launch) -> quadtree
distribution, per-level compaction and the front-pack of all levels into
one fixed-capacity set, keypoints scaled to level-0 coordinates (K17, one
call) -> orientation + blur + rotated BRIEF of the packed slots (K2, one
launch).  Nothing in a frame synchronises with the host.

The JAX package describes each level's compacted slots and then packs
the merged set (``_truncate``); describing is per keypoint and gives an
invalid slot angle 0 and zero bytes, so describing the packed slots gives
the same ``Features``.  On the CPU every stage runs its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..config import ORBConfig
from . import fast as ffast
from .brief import DescribePlan, orb_describe
from .octree import D_MAX, OctreePlan, distribute_device, path_code_tables
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


def _pack_order(valid: torch.Tensor, capacity: int):
    """The slots of a stable front-pack of ``valid``: (order, packed valid)."""
    n = valid.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=valid.device)
    key = torch.where(valid, idx, n + idx)  # unique
    skey, order = torch.sort(key)
    return order[:capacity], skey[:capacity] < n


def _truncate(feats: Features, capacity: int) -> Features:
    """Front-pack valid features into a fixed-capacity Features,
    preserving level order (the reference's per-level concatenation)."""
    order, valid = _pack_order(feats.valid, capacity)
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


class Selected(NamedTuple):
    """The selected keypoints of every level, front-packed in level order
    (K17's outputs; ``lvl_*`` are the per-level compacted slots before the
    pack, ``depth`` the quadtree depth used per level)."""

    xy: torch.Tensor         # (n_out, 2) int32 inner coords of its level, 0 when invalid
    octave: torch.Tensor     # (n_out,) int32 level, -1 when invalid
    valid: torch.Tensor      # (n_out,) bool
    xy_f: torch.Tensor       # (n_out, 2) float32 level-0 coords
    response: torch.Tensor   # (n_out,) float32
    size: torch.Tensor       # (n_out,) float32
    depth: torch.Tensor      # (L,) int32
    lvl_xy: torch.Tensor     # (sum cap_l, 2) int32
    lvl_resp: torch.Tensor   # (sum cap_l,) int32
    lvl_valid: torch.Tensor  # (sum cap_l,) bool


# cell-table ints K17 keeps in shared memory (octree_select.cu kTabCap): a
# level whose n_ini * 4^7 depth-7 cells pass it has its table in the workspace
SELECT_TAB_CAP = 16384


class SelectPlan:
    """Static inputs of K17 for one extractor: per level the candidate
    count and offset (K16's layout), cap_l and its offset, the budget, the
    quadtree's origin and box, its per-axis path-code tables
    (``octree.path_code_tables``, one int32 buffer on the device), its
    top-level cell count n_ini, the offset of its cell table in the
    workspace (-1 where it fits in shared memory) and the level's scale
    factor."""

    def __init__(self, levels, budgets, scales, capacity: int, min_b: int, device):
        parts, rows, pos, k_off, cap_off, ws = [], [], 0, 0, 0, 0
        for (k, cap, octree), budget, scale in zip(levels, budgets, scales):
            px, py = path_code_tables(octree)
            parts += [px.numpy(), py.numpy()]
            n_ini = octree.n_cx[0]
            ws_off = -1
            if n_ini * 4 ** D_MAX > SELECT_TAB_CAP:
                ws_off, ws = ws, ws + n_ini * 4 ** D_MAX
            rows.append([k, k_off, cap, cap_off, budget, min_b, min_b, octree.width,
                         octree.height, pos, pos + px.numel(), n_ini, ws_off,
                         int(np.float32(scale).view(np.int32))])
            pos += px.numel() + py.numel()
            k_off += k
            cap_off += cap
        self.n_cand, self.n_lvl_slots = k_off, cap_off
        self.n_out = min(capacity, cap_off)
        self.n_levels = len(rows)
        self.ws_ints = ws
        words = 512 * max(r[11] for r in rows)
        list_n = max(k for k, _, _ in levels)
        self.tables = torch.as_tensor(np.concatenate(parts), device=device)
        self.table = np.ascontiguousarray(np.concatenate(
            [[len(rows), self.n_out, words, list_n], np.asarray(rows, np.int64).reshape(-1)]
        ).astype(np.int32))


def select_keypoints_plain(xy, resp, valid, ex: "ORBExtractor") -> Selected:
    """Plain version of ``select_keypoints``: ``distribute_device`` and
    ``_compact`` per level, then ``_truncate``'s front-pack of the slots
    with ``_merge``'s level-0 scaling."""
    xys, resps, valids, depths, k_off = [], [], [], [], 0
    for lvl, (k_lvl, cap_l, octree) in enumerate(ex.levels):
        sl = slice(k_off, k_off + k_lvl)
        k_off += k_lvl
        sel, depth = distribute_device(xy[sl], resp[sl], valid[sl], ex.budgets[lvl], octree)
        x, r, v = _compact(xy[sl], resp[sl], valid[sl] & sel, cap_l)
        xys.append(x)
        resps.append(r)
        valids.append(v)
        depths.append(depth.to(torch.int32))
    lxy, lresp, lvalid = torch.cat(xys), torch.cat(resps), torch.cat(valids)
    order, pv = _pack_order(lvalid, ex.capacity)
    level = ex._level_ids[order]
    scales = ex._scales_t[level]
    pxy = lxy[order]
    return Selected(torch.where(pv[:, None], pxy, 0), torch.where(pv, level, -1), pv,
                    torch.where(pv[:, None], pxy.to(torch.float32) * scales[:, None], 0.0),
                    torch.where(pv, lresp[order].to(torch.float32), 0.0),
                    torch.where(pv, 31.0 * scales, 0.0), torch.stack(depths), lxy, lresp, lvalid)


def select_keypoints(xy, resp, valid, ex: "ORBExtractor") -> Selected:
    """Quadtree distribution, per-level compaction and the front-pack of
    every level's collected candidates (``collect_levels``' layout).

    Replaces ``extractorb_tpu/frontend/octree.py:distribute_device``,
    ``extractor.py:_compact`` and ``_truncate`` (with the level-0 scaling
    of ``_merge``).  On CUDA tensors this launches K17 (one launch: a
    cluster with a CTA per level, the pack after its barrier); on the CPU
    it runs ``select_keypoints_plain``."""
    if not xy.is_cuda:
        return select_keypoints_plain(xy, resp, valid, ex)
    plan = ex.select_plan
    xy, resp, valid = xy.contiguous(), resp.contiguous(), valid.contiguous()
    kernels.require_cuda("octree_select", xy, resp, valid, plan.tables)
    if xy.shape != (plan.n_cand, 2) or xy.dtype != torch.int32 or resp.dtype != torch.int32 \
            or resp.shape != (plan.n_cand,) or valid.shape != (plan.n_cand,) \
            or valid.dtype != torch.bool:
        raise ValueError(f"octree_select: expected {plan.n_cand} int32 candidates and a bool mask")
    dev, L, S, n = xy.device, plan.n_levels, plan.n_lvl_slots, plan.n_out
    i32 = lambda *shape: torch.empty(*shape, dtype=torch.int32, device=dev)
    f32 = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)
    b8 = lambda *shape: torch.empty(*shape, dtype=torch.bool, device=dev)
    out = Selected(i32(n, 2), i32(n), b8(n), f32(n, 2), f32(n), f32(n), i32(L),
                   i32(S, 2), i32(S), b8(S))
    ws = i32(plan.ws_ints) if plan.ws_ints else None
    err = kernels.lib().octree_select_launch(
        xy.data_ptr(), resp.data_ptr(), valid.data_ptr(), plan.tables.data_ptr(),
        plan.table.ctypes.data, None if ws is None else ws.data_ptr(),
        out.lvl_xy.data_ptr(), out.lvl_resp.data_ptr(), out.lvl_valid.data_ptr(),
        out.depth.data_ptr(), out.xy.data_ptr(), out.octave.data_ptr(), out.valid.data_ptr(),
        out.xy_f.data_ptr(), out.response.data_ptr(), out.size.data_ptr(), kernels.stream())
    kernels.check(err, "octree_select")
    kernels.LAUNCHES["octree_select"] += 1
    return out


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
        self.collect_plan = ffast.CollectPlan(self.fast_plan, [k for k, _, _ in self.levels])
        self.select_plan = SelectPlan(self.levels, self.budgets, self.scales, self.capacity,
                                      min_b, self.device)

    def __call__(self, img: torch.Tensor) -> Features:
        """Extract ORB features from a uint8 grayscale image (H, W) on
        this extractor's device, into ``self.capacity`` slots."""
        return self.extract_with_pyramid(img)[0]

    def extract_with_pyramid(self, img: torch.Tensor) -> Tuple[Features, Pyramid]:
        """``__call__`` that also returns the bordered pyramid it built
        (levels laid out by ``self.pyr_plan``), so that the stereo match
        reads it instead of building it again."""
        pyr = compute_pyramid(img.to(self.device), self.pyr_plan)
        sel = self.keypoints(pyr)
        angle, desc = orb_describe(pyr, self.desc_plan, sel.xy, sel.octave, sel.valid)
        return Features(xy=sel.xy_f, response=sel.response, angle=angle, octave=sel.octave,
                        size=sel.size, desc=desc, valid=sel.valid), pyr

    def keypoints(self, pyr) -> Selected:
        """FAST (K1), per-level top-K (K16), quadtree, compaction and the
        pack of all levels (K17): the selected keypoints, packed."""
        cfg = self.cfg
        keeps, scores = ffast.fast_detect(pyr, self.fast_plan, cfg.ini_th_fast, cfg.min_th_fast)
        return select_keypoints(*ffast.collect_levels(keeps, scores, self.collect_plan), self)
