"""Image pyramid with bit-exact OpenCV INTER_LINEAR semantics
(port of ``extractorb_tpu/frontend/pyramid.py``).

Level L is resized from level L-1 with cv::INTER_LINEAR to
cvRound(w0 / scale^L) and padded with a 19-px BORDER_REFLECT_101 border.
The fixed-point tables are the JAX package's, verbatim.  The horizontal
pass is an int32 two-tap gather (the JAX package uses an f32 matmul on
the MXU), so exactness never depends on TF32 settings.

All bordered levels live in ONE flat uint8 buffer (``Pyramid.flat``);
``Pyramid.levels`` are (h+38, w+38) views into it.  The FAST and
descriptor kernels read every level of the flat buffer in one launch
through per-level (offset, stride) tables.

``compute_pyramid`` is kernel K15 (``csrc/pyramid.cu``, one launch per
level) on a CUDA image and its plain version, ``compute_pyramid_plain``,
on a CPU one.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels

EDGE_THRESHOLD = 19  # reference inc/ORBExtractor.h:20
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS  # 2048


def cv_round(x):
    """OpenCV cvRound = round-half-to-even (banker's rounding)."""
    return np.rint(x).astype(np.int64)


def pyramid_sizes(w0: int, h0: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    """Per-level (w, h), using cvRound(dim * invScale) like the reference."""
    inv_acc = [1.0 / (scale_factor ** l) for l in range(n_levels)]
    return [(int(cv_round(w0 * s)), int(cv_round(h0 * s))) for s in inv_acc]


def _interp_tables(src: int, dst: int):
    """OpenCV resize INTER_LINEAR offsets + 11-bit fixed-point weights."""
    # Bit-exactness requires OpenCV's float32 weight math: fx is computed
    # in double then CAST TO FLOAT32 before the fractional split, and the
    # 2048-scale products are float32 (resize.cpp).
    scale = src / dst
    dx = np.arange(dst)
    fx = ((dx + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    # boundary clamps (resize.cpp)
    low = sx < 0
    fx[low] = 0.0
    sx[low] = 0
    high = sx >= src - 1
    fx[high] = 0.0
    sx[high] = src - 1
    csc = np.float32(_COEF_SCALE)
    a0 = cv_round(((np.float32(1.0) - fx) * csc).astype(np.float32)).astype(np.int32)
    a1 = cv_round((fx * csc).astype(np.float32)).astype(np.int32)
    s1 = np.minimum(sx + 1, src - 1)
    return sx, s1, a0, a1


def _reflect101_indices(n: int, border: int) -> np.ndarray:
    """Index map implementing BORDER_REFLECT_101: gfedcb|abcdefgh|gfedcba."""
    idx = np.arange(-border, n + border)
    period = 2 * (n - 1) if n > 1 else 1
    idx = np.abs(idx) % period
    idx = np.where(idx >= n, period - idx, idx)
    return idx.astype(np.int64)


class _ResizeTables(NamedTuple):
    sx0: torch.Tensor
    sx1: torch.Tensor
    a0: torch.Tensor
    a1: torch.Tensor
    sy0: torch.Tensor
    sy1: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor


def resize_tables(src_w: int, src_h: int, dst_w: int, dst_h: int, device) -> _ResizeTables:
    sx0, sx1, a0, a1 = _interp_tables(src_w, dst_w)
    sy0, sy1, b0, b1 = _interp_tables(src_h, dst_h)
    as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return _ResizeTables(
        as_t(sx0, torch.long), as_t(sx1, torch.long),
        as_t(a0, torch.int32), as_t(a1, torch.int32),
        as_t(sy0, torch.long), as_t(sy1, torch.long),
        as_t(b0, torch.int32)[:, None], as_t(b1, torch.int32)[:, None],
    )


def resize_u8(img: torch.Tensor, tab: _ResizeTables) -> torch.Tensor:
    """Bit-exact cv2.resize(img, (dst_w, dst_h), INTER_LINEAR) for uint8."""
    x = img.to(torch.int32)
    # horizontal pass: exact int32 two-tap sum (<= 255 * 2048)
    S = x[:, tab.sx0] * tab.a0 + x[:, tab.sx1] * tab.a1
    # vertical pass: uchar specialisation of VResizeLinear (resize.cpp):
    # D = (((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2
    S4 = S >> 4
    out = (((S4[tab.sy0] * tab.b0) >> 16) + ((S4[tab.sy1] * tab.b1) >> 16) + 2) >> 2
    return out.clamp(0, 255).to(torch.uint8)


class Pyramid(NamedTuple):
    flat: torch.Tensor            # all bordered levels, flattened, uint8
    levels: List[torch.Tensor]    # (h+38, w+38) views into ``flat``


class PyramidPlan:
    """Static per-shape tables of one pyramid (built once per image shape
    and device, so a frame uploads nothing but the image)."""

    def __init__(self, w0: int, h0: int, n_levels: int, scale_factor: float, device):
        self.sizes = pyramid_sizes(w0, h0, n_levels, scale_factor)
        b = EDGE_THRESHOLD
        self.shapes = [(h + 2 * b, w + 2 * b) for (w, h) in self.sizes]
        self.offsets = [0]
        for hb, wb in self.shapes:
            self.offsets.append(self.offsets[-1] + hb * wb)
        self.total = self.offsets.pop()
        self.resize = [None] + [
            resize_tables(pw, ph, w, h, device)
            for (pw, ph), (w, h) in zip(self.sizes[:-1], self.sizes[1:])
        ]
        self.ry = [torch.as_tensor(_reflect101_indices(h, b), device=device)
                   for (_, h) in self.sizes]
        self.rx = [torch.as_tensor(_reflect101_indices(w, b), device=device)
                   for (w, _) in self.sizes]
        # K15's tables: per level > 0 sx0|sx1|a0|a1 (w each) then sy0|sy1|b0|b1
        # (h each) in one int32 buffer, and the host rows (b_off, stride, w, h,
        # table offset) it launches with
        parts, rows, pos = [], [], 0
        for lvl, ((w, h), (_, wb), off) in enumerate(zip(self.sizes, self.shapes, self.offsets)):
            rows.append([off, wb, w, h, pos])
            if lvl:
                (pw, ph) = self.sizes[lvl - 1]
                tx, ty = _interp_tables(pw, w), _interp_tables(ph, h)
                parts += [np.asarray(a, np.int32) for a in tx + ty]
                pos += 4 * (w + h)
        self.k15_table = torch.as_tensor(np.concatenate(parts) if parts else
                                         np.zeros(1, np.int32), device=device)
        self.k15_rows = np.ascontiguousarray(
            np.concatenate([[n_levels, b], np.asarray(rows).reshape(-1)]).astype(np.int32))


def compute_pyramid_plain(img: torch.Tensor, plan: PyramidPlan) -> Pyramid:
    """Plain version of ``compute_pyramid``: ``resize_u8`` level by level
    and the reflect-101 border through the plan's index maps."""
    flat = torch.empty(plan.total, dtype=torch.uint8, device=img.device)
    levels = []
    inner = img
    for lvl, (off, (hb, wb)) in enumerate(zip(plan.offsets, plan.shapes)):
        if lvl > 0:
            inner = resize_u8(inner, plan.resize[lvl])
        view = flat[off:off + hb * wb].view(hb, wb)
        # copyMakeBorder(BORDER_REFLECT_101) through the plan's index maps
        view.copy_(inner[plan.ry[lvl]][:, plan.rx[lvl]])
        levels.append(view)
    return Pyramid(flat, levels)


def compute_pyramid(img: torch.Tensor, plan: PyramidPlan) -> Pyramid:
    """Full pyramid of BORDERED uint8 levels (h+38, w+38); the inner image
    of a level is ``level[19:-19, 19:-19]``.

    Replaces ``extractorb_tpu/frontend/pyramid.py:compute_pyramid`` (with
    ``_resize_u8`` and ``add_border_reflect101``).  On a CUDA image this
    launches K15 (one launch per level, counted once per call); on the CPU
    it runs ``compute_pyramid_plain``."""
    if not img.is_cuda:
        return compute_pyramid_plain(img, plan)
    img = img.contiguous()
    kernels.require_cuda("pyramid", img, plan.k15_table)
    h0, w0 = plan.shapes[0][0] - 2 * EDGE_THRESHOLD, plan.shapes[0][1] - 2 * EDGE_THRESHOLD
    if img.dtype != torch.uint8 or tuple(img.shape) != (h0, w0):
        raise ValueError(f"pyramid: expected a uint8 ({h0}, {w0}) image, got "
                         f"{img.dtype} {tuple(img.shape)}")
    flat = torch.empty(plan.total, dtype=torch.uint8, device=img.device)
    err = kernels.lib().pyramid_launch(img.data_ptr(), flat.data_ptr(),
                                       plan.k15_table.data_ptr(), plan.k15_rows.ctypes.data,
                                       kernels.stream())
    kernels.check(err, "pyramid")
    kernels.LAUNCHES["pyramid"] += 1
    return Pyramid(flat, [flat[off:off + hb * wb].view(hb, wb)
                          for off, (hb, wb) in zip(plan.offsets, plan.shapes)])
