"""IC_Angle keypoint orientation (port of ``extractorb_tpu/frontend/orientation.py``).

The plain version here; kernel K2 (``brief.orb_describe``) fuses it with
the blur and the descriptor.  The angle is OpenCV's fastAtan2 polynomial
in float32, evaluated the way XLA:CPU compiles the JAX function: the
multiply-adds of the polynomial are contracted into fused multiply-adds.
``_fma`` reproduces one fused multiply-add with float64 arithmetic (the
float32 product is exact in float64), so the CPU, the card's plain path
and the kernel all round alike.
"""

from __future__ import annotations

import numpy as np
import torch

HALF_PATCH_SIZE = 15  # reference inc/ORBExtractor.h:19


def compute_umax() -> np.ndarray:
    """Circular patch bounds, exactly the reference ctor loop
    (ORBextractor.cc:453-475)."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 2, np.int64)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    hp2 = float(hp * hp)
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(hp2 - v * v)))
    # ensure symmetry
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: hp + 1]


UMAX = compute_umax()
_HP = HALF_PATCH_SIZE
_MASK = np.abs(np.arange(-_HP, _HP + 1))[None, :] <= UMAX[np.abs(np.arange(-_HP, _HP + 1))][:, None]
_WU = (np.arange(-_HP, _HP + 1)[None, :] * _MASK).astype(np.int32)  # u weights
_WV = (np.arange(-_HP, _HP + 1)[:, None] * _MASK).astype(np.int32)  # v weights

# OpenCV fastAtan2 constants (modules/core/src/mathfuncs.cpp), as float32
_P1 = float(np.float32(0.9997878412794807 * (180.0 / np.pi)))
_P3 = float(np.float32(-0.3258083974640975 * (180.0 / np.pi)))
_P5 = float(np.float32(0.1555786518463281 * (180.0 / np.pi)))
_P7 = float(np.float32(-0.04432655554792128 * (180.0 / np.pi)))
_FLT_EPS = float(np.finfo(np.float32).eps)


def _fma(a, b, c) -> torch.Tensor:
    """float32 fused multiply-add a*b + c with one rounding (through
    float64, where the float32 product is exact)."""
    dbl = lambda v: v.double() if isinstance(v, torch.Tensor) else float(v)
    return (dbl(a) * dbl(b) + dbl(c)).float()


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """cv::fastAtan2 in float32: degrees in [0, 360)."""
    y = y.float()
    x = x.float()
    ax, ay = x.abs(), y.abs()
    big = ax >= ay
    c = torch.where(big, ay, ax) / (torch.where(big, ax, ay) + _FLT_EPS)
    c2 = c * c
    a = _fma(_fma(_fma(_P7, c2, _P5), c2, _P3), c2, _P1) * c
    a = torch.where(big, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    a = torch.where(y < 0, 360.0 - a, a)
    return a


def _patch_offsets(stride: int, half: int, device) -> torch.Tensor:
    r = torch.arange(-half, half + 1, device=device)
    return (r[:, None] * stride + r[None, :]).reshape(-1)


def gather_patches(bordered: torch.Tensor, xy: torch.Tensor, half: int,
                   border: int = 19) -> torch.Tensor:
    """(K, 2*half+1, 2*half+1) uint8 patches of ``bordered`` centred on the
    inner coords ``xy`` (int32)."""
    stride = bordered.shape[1]
    centre = (xy[:, 1].long() + border) * stride + (xy[:, 0].long() + border)
    idx = centre[:, None] + _patch_offsets(stride, half, bordered.device)[None, :]
    n = 2 * half + 1
    return bordered.reshape(-1)[idx].reshape(-1, n, n)


def ic_angle(bordered: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
             border: int = 19) -> torch.Tensor:
    """IC_Angle in degrees (K,) float32, over the 31-px umax disc of the
    UNBLURRED level (the reference orients before it blurs).  Invalid
    slots get angle 0."""
    xy0 = torch.where(valid[:, None], xy, 0)
    p = gather_patches(bordered, xy0, _HP, border).to(torch.int32)
    wu = torch.as_tensor(_WU, device=p.device)
    wv = torch.as_tensor(_WV, device=p.device)
    # int32 sums are exact and equal the JAX f32 contraction (|m| < 2^24)
    m10 = (p * wu).sum((1, 2))
    m01 = (p * wv).sum((1, 2))
    return torch.where(valid, fast_atan2_deg(m01, m10), 0.0)
