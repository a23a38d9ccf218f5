"""Frame feature grid: PosInGrid, AssignFeaturesToGrid, GetFeaturesInArea
(port of ``extractorb_tpu/frontend/grid.py``; reference src/Frame.cc:383-417,
:655-724, :726-737, grid constants inc/Frame.h:39-40).

Each function runs K28 (``csrc/grid.cu``) on CUDA tensors and its
``*_plain`` version on the CPU.  The plain versions repeat the JAX
functions' float32 arithmetic operation by operation (no product is
followed by a sum, so nothing is contracted): the cell of a keypoint is
``floor((x - min_x) * (cols / (max_x - min_x)))``, and a cell keeps the
first ``cell_capacity`` keypoints by index while ``counts`` counts all of
them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

FRAME_GRID_COLS = 64  # reference inc/Frame.h:39
FRAME_GRID_ROWS = 48  # reference inc/Frame.h:40
# the cell counters of K28's grid_assign live in 48 KB of shared memory
MAX_CELLS = 12000


def pos_in_grid_plain(xy_un, bounds, valid, rows: int = FRAME_GRID_ROWS,
                      cols: int = FRAME_GRID_COLS, strict: bool = True):
    """Plain version of ``pos_in_grid``."""
    min_x, max_x, min_y, max_y = bounds[0], bounds[1], bounds[2], bounds[3]
    inv_w = cols / (max_x - min_x)
    inv_h = rows / (max_y - min_y)
    cx = torch.floor((xy_un[:, 0] - min_x) * inv_w).to(torch.int32)
    cy = torch.floor((xy_un[:, 1] - min_y) * inv_h).to(torch.int32)
    ok = valid & (cx >= 0) & (cx < cols) & (cy >= 0) & (cy < rows)
    if not strict:
        cx = torch.clamp(cx, 0, cols - 1)
        cy = torch.clamp(cy, 0, rows - 1)
    return torch.stack([cx, cy], -1), ok


def _check(name: str, xy_un, valid, *more):
    n = xy_un.shape[0]
    if xy_un.dim() != 2 or xy_un.shape[1] != 2 or xy_un.dtype != torch.float32 \
            or valid.shape != (n,) or valid.dtype != torch.bool:
        raise ValueError(f"{name}: expected (N,2) float32 keypoints and an (N,) bool mask")
    tensors = [t.contiguous() for t in (xy_un, valid, *more)]
    kernels.require_cuda(name, *tensors)
    return tensors


def _bounds(name: str, bounds, device):
    if bounds.shape != (4,) or bounds.dtype != torch.float32:
        raise ValueError(f"{name}: expected (4,) float32 bounds [min_x, max_x, min_y, max_y]")
    return bounds.to(device).contiguous()


def pos_in_grid(xy_un: torch.Tensor, bounds: torch.Tensor, valid: torch.Tensor,
                rows: int = FRAME_GRID_ROWS, cols: int = FRAME_GRID_COLS,
                strict: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cell (col, row) per keypoint and the in-grid mask (Frame::PosInGrid):
    (N,2) int32, (N,) bool.  bounds: (4,) float32 [min_x, max_x, min_y,
    max_y].  ``strict=False`` clamps the cells of keypoints outside the
    bounds into the grid (the mask still marks them).

    Replaces ``extractorb_tpu/frontend/grid.py:pos_in_grid``: K28's
    ``grid_pos`` on CUDA tensors (a thread per keypoint)."""
    if not xy_un.is_cuda:
        return pos_in_grid_plain(xy_un, bounds, valid, rows, cols, strict)
    xy_un, valid = _check("grid_pos", xy_un, valid)
    bounds = _bounds("grid_pos", bounds, xy_un.device)
    n = xy_un.shape[0]
    cell = torch.empty((n, 2), dtype=torch.int32, device=xy_un.device)
    ok = torch.empty((n,), dtype=torch.bool, device=xy_un.device)
    err = kernels.lib().grid_pos_launch(xy_un.data_ptr(), bounds.data_ptr(), valid.data_ptr(), n,
                                        rows, cols, int(strict), cell.data_ptr(), ok.data_ptr(),
                                        kernels.stream())
    kernels.check(err, "grid_pos")
    kernels.LAUNCHES["grid_pos"] += 1
    return cell, ok


def assign_features_to_grid_plain(xy_un, bounds, valid, rows: int = FRAME_GRID_ROWS,
                                  cols: int = FRAME_GRID_COLS, cell_capacity: int = 16):
    """Plain version of ``assign_features_to_grid``: a stable sort by cell,
    each keypoint's rank among its cell's, one scatter (the JAX function's
    construction)."""
    n = xy_un.shape[0]
    dev = xy_un.device
    cell, ok = pos_in_grid_plain(xy_un, bounds, valid, rows, cols)
    n_cells = rows * cols
    cid = torch.where(ok, cell[:, 1] * cols + cell[:, 0], n_cells).to(torch.int64)
    cid_s, order = torch.sort(cid, stable=True)
    first = torch.searchsorted(cid_s, cid_s, side="left")
    rank = torch.arange(n, device=dev) - first
    keep = (cid_s < n_cells) & (rank < cell_capacity)
    flat = torch.full((n_cells * cell_capacity,), -1, dtype=torch.int32, device=dev)
    flat[(cid_s * cell_capacity + rank)[keep]] = order[keep].to(torch.int32)
    counts = torch.bincount(cid, minlength=n_cells + 1)[:n_cells].to(torch.int32)
    return flat.reshape(rows, cols, cell_capacity), counts.reshape(rows, cols)


def assign_features_to_grid(xy_un: torch.Tensor, bounds: torch.Tensor, valid: torch.Tensor,
                            rows: int = FRAME_GRID_ROWS, cols: int = FRAME_GRID_COLS,
                            cell_capacity: int = 16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-shape grid index (Frame::AssignFeaturesToGrid): (rows, cols,
    cell_capacity) int32 keypoint indices, -1 padded, ascending within a
    cell, and (rows, cols) int32 counts of every in-grid keypoint (also
    those past the capacity).

    Replaces ``extractorb_tpu/frontend/grid.py:assign_features_to_grid``:
    K28's ``grid_assign`` on CUDA tensors (one CTA: the cell counters in
    shared memory, one warp walking the keypoints in chunks of 32 in index
    order, a lane's rank from ``__match_any_sync``; no atomic decides a
    slot)."""
    if not xy_un.is_cuda:
        return assign_features_to_grid_plain(xy_un, bounds, valid, rows, cols, cell_capacity)
    if rows * cols > MAX_CELLS or cell_capacity < 1:
        raise ValueError(f"grid_assign: {rows}x{cols} cells of {cell_capacity}: the kernel "
                         f"takes up to {MAX_CELLS} cells of at least one slot")
    xy_un, valid = _check("grid_assign", xy_un, valid)
    bounds = _bounds("grid_assign", bounds, xy_un.device)
    dev = xy_un.device
    grid = torch.empty((rows, cols, cell_capacity), dtype=torch.int32, device=dev)
    counts = torch.empty((rows, cols), dtype=torch.int32, device=dev)
    err = kernels.lib().grid_assign_launch(xy_un.data_ptr(), bounds.data_ptr(), valid.data_ptr(),
                                           xy_un.shape[0], rows, cols, cell_capacity,
                                           grid.data_ptr(), counts.data_ptr(), kernels.stream())
    kernels.check(err, "grid_assign")
    kernels.LAUNCHES["grid_assign"] += 1
    return grid, counts


def features_in_area_mask_plain(xy_un, octave, valid, x: float, y: float, r: float,
                                min_level: int, max_level: int):
    """Plain version of ``features_in_area_mask``."""
    dx = torch.abs(xy_un[:, 0] - x)
    dy = torch.abs(xy_un[:, 1] - y)
    in_box = (dx < r) & (dy < r)
    if (min_level > 0) or (max_level >= 0):
        in_box = in_box & (octave >= min_level) & (octave <= max_level)
    return valid & in_box


def features_in_area_mask(xy_un: torch.Tensor, octave: torch.Tensor, valid: torch.Tensor,
                          x: float, y: float, r: float, min_level: int,
                          max_level: int) -> torch.Tensor:
    """(N,) bool: Frame::GetFeaturesInArea as a dense mask: |x_i - x| < r,
    |y_i - y| < r and, unless min_level <= 0 and max_level < 0 (the
    reference's bCheckLevels), min_level <= octave <= max_level.  x, y, r
    are taken in float32, the levels as integers.

    Replaces ``extractorb_tpu/frontend/grid.py:features_in_area_mask``:
    K28's ``grid_area`` on CUDA tensors (a thread per keypoint)."""
    x, y, r, min_level, max_level = float(x), float(y), float(r), int(min_level), int(max_level)
    if not xy_un.is_cuda:
        return features_in_area_mask_plain(xy_un, octave, valid, x, y, r, min_level, max_level)
    if octave.shape != valid.shape or octave.dtype != torch.int32:
        raise ValueError("grid_area: expected (N,) int32 octaves")
    xy_un, valid, octave = _check("grid_area", xy_un, valid, octave)
    n = xy_un.shape[0]
    out = torch.empty((n,), dtype=torch.bool, device=xy_un.device)
    err = kernels.lib().grid_area_launch(xy_un.data_ptr(), octave.data_ptr(), valid.data_ptr(),
                                         n, x, y, r, min_level, max_level, out.data_ptr(),
                                         kernels.stream())
    kernels.check(err, "grid_area")
    kernels.LAUNCHES["grid_area"] += 1
    return out
