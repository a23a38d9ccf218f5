"""Rotated-BRIEF 256-bit descriptors (port of ``extractorb_tpu/frontend/brief.py``)
and kernel K2, ``orb_describe`` (orientation + blur + BRIEF, fused).

The 512-point pattern is OpenCV's bit_pattern_31_, read from the port's
own copy of it (``extractorb_tpu_torch/data/orb_pattern.npy``, the same
bytes as the JAX package's data file).

Rounding follows the JAX function as XLA:CPU compiles it: the sample
offsets are ``rint(fma(px, sin, py*cos))`` and
``rint(fma(px, cos, -(py*sin)))`` in float32.  Only cos/sin differ: they
are taken in float64 and rounded to float32 (correctly rounded, where
XLA's float32 cos/sin are not), in the plain version and in the kernel
alike.  A sample whose offset lands within an ulp of a rounding boundary
can therefore differ from the JAX package; the parity tests hold the
descriptors bit-equal on their inputs.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from .blur import blur_level
from .orientation import UMAX, _fma, ic_angle
from .pyramid import EDGE_THRESHOLD, Pyramid

PATTERN_FILE = Path(__file__).resolve().parents[1] / "data" / "orb_pattern.npy"
_DEG2RAD = float(np.float32(np.pi / 180.0))
PATCH_RADIUS = 18  # rotated samples stay within radius 18.4


@functools.lru_cache(maxsize=None)
def _pattern():
    """(256, 4) int8 pattern (x0 y0 x1 y1 per pair), read on first use,
    and its 512 points as float32 (px, py): points 2i and 2i+1 are the
    pair compared for bit i."""
    pat = np.load(PATTERN_FILE).astype(np.int8)
    pat.flags.writeable = False
    px = pat[:, [0, 2]].reshape(-1).astype(np.float32)
    py = pat[:, [1, 3]].reshape(-1).astype(np.float32)
    return pat, px, py


def _cos_sin(angles_deg: torch.Tensor):
    ang = (angles_deg.float() * _DEG2RAD).double()
    return torch.cos(ang).float(), torch.sin(ang).float()


def compute_descriptors(blurred_bordered: torch.Tensor, xy: torch.Tensor,
                        angles_deg: torch.Tensor, valid: torch.Tensor,
                        border: int = EDGE_THRESHOLD) -> torch.Tensor:
    """(K,) keypoints -> (K, 256) bool descriptor bits, sampled on the
    blurred level.  Invalid slots get all-zero bits."""
    a, b = _cos_sin(angles_deg)
    _, px, py = _pattern()
    px = torch.as_tensor(px, device=xy.device)[None, :]
    py = torch.as_tensor(py, device=xy.device)[None, :]
    a, b = a[:, None], b[:, None]
    dy = torch.round(_fma(px, b, py * a)).to(torch.int64).clamp(-PATCH_RADIUS, PATCH_RADIUS)
    dx = torch.round(_fma(px, a, -(py * b))).to(torch.int64).clamp(-PATCH_RADIUS, PATCH_RADIUS)
    stride = blurred_bordered.shape[1]
    xy0 = torch.where(valid[:, None], xy, 0).long()
    centre = (xy0[:, 1:2] + border) * stride + (xy0[:, 0:1] + border)
    samples = blurred_bordered.reshape(-1)[centre + dy * stride + dx].to(torch.int32)
    bits = samples[:, 0::2] < samples[:, 1::2]
    return bits & valid[:, None]


def pack_bits_u8(bits: torch.Tensor) -> torch.Tensor:
    """(K, 256) bool -> (K, 32) uint8, bit j of byte i = bit 8i+j."""
    K = bits.shape[0]
    w = torch.tensor([1 << j for j in range(8)], dtype=torch.int32, device=bits.device)
    return (bits.reshape(K, 32, 8).to(torch.int32) * w).sum(-1).to(torch.uint8)


class DescribePlan:
    """K2's static inputs for one pyramid shape: per-level (offset,
    stride) of the flat pyramid, the pattern (int8) and umax (int32)."""

    def __init__(self, pyramid_shapes, pyramid_offsets, device,
                 border: int = EDGE_THRESHOLD):
        self.border = border
        rows = [[off, wb] for (_, wb), off in zip(pyramid_shapes, pyramid_offsets)]
        self.table = np.ascontiguousarray(
            np.concatenate([[len(rows), border], np.asarray(rows).reshape(-1)]).astype(np.int32))
        self.pattern = torch.tensor(_pattern()[0], device=device)
        self.umax = torch.as_tensor(UMAX.astype(np.int32), device=device).contiguous()


def orb_describe_plain(pyr: Pyramid, plan: DescribePlan, xy: torch.Tensor,
                       level: torch.Tensor, valid: torch.Tensor):
    """Plain version of ``orb_describe``: IC angle, blurred level and
    descriptors, level by level."""
    K, dev = xy.shape[0], xy.device
    angle = torch.zeros(K, dtype=torch.float32, device=dev)
    desc = torch.zeros(K, 32, dtype=torch.uint8, device=dev)
    for lvl, bordered in enumerate(pyr.levels):
        idx = torch.nonzero(valid & (level == lvl))[:, 0]
        ok = torch.ones(idx.numel(), dtype=torch.bool, device=dev)
        a = ic_angle(bordered, xy[idx], ok, plan.border)
        bits = compute_descriptors(blur_level(bordered, plan.border), xy[idx], a, ok, plan.border)
        angle[idx] = a
        desc[idx] = pack_bits_u8(bits)
    return angle, desc


def orb_describe(pyr: Pyramid, plan: DescribePlan, xy: torch.Tensor,
                 level: torch.Tensor, valid: torch.Tensor):
    """IC angle (degrees, float32) and packed 32-byte rotated-BRIEF
    descriptor of keypoints from any pyramid level.

    Replaces ``extractorb_tpu/frontend/orientation.py:ic_angle``,
    ``blur.py:blur_level`` and ``brief.py:compute_descriptors`` +
    ``pack_bits_u8``.  xy: (K, 2) int32 inner coords of level ``level``
    (K,) int32.  Invalid slots get angle 0 and zero bytes.  On CUDA
    tensors this launches K2 once for all levels; on the CPU it runs the
    plain functions level by level."""
    K = xy.shape[0]
    if not pyr.flat.is_cuda:
        return orb_describe_plain(pyr, plan, xy, level, valid)
    xy = xy.to(torch.int32).contiguous()
    level = level.to(torch.int32).contiguous()
    valid = valid.contiguous()
    kernels.require_cuda("orb_describe", pyr.flat, xy, level, valid, plan.pattern, plan.umax)
    angle = torch.empty(K, dtype=torch.float32, device=xy.device)
    desc = torch.empty(K, 32, dtype=torch.uint8, device=xy.device)
    err = kernels.lib().orb_describe_launch(
        pyr.flat.data_ptr(), xy.data_ptr(), level.data_ptr(), valid.data_ptr(), K,
        plan.pattern.data_ptr(), plan.umax.data_ptr(), plan.table.ctypes.data,
        angle.data_ptr(), desc.data_ptr(), kernels.stream(),
    )
    kernels.check(err, "orb_describe")
    kernels.LAUNCHES["orb_describe"] += 1
    return angle, desc
