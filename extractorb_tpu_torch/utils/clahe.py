"""CLAHE preprocessing: contrast-limited adaptive histogram equalisation
(port of ``extractorb_tpu/utils/clahe.py``).

Replaces the reference's cv::createCLAHE(3.0, (8,8)) stage of its demos
(src/clahe/main_clahe.cpp:7-11, main_orb_extractor.cpp:19-25).

``clahe_plain`` repeats, operation by operation, the float32 program that
XLA:CPU compiles from the JAX function (read from its optimised HLO):

- the clip excess is summed in 8 runs of 32 bins, each run and the run
  totals in order;
- the cumulative histogram is XLA's blocked scan: 16 runs of 16 bins, a
  prefix inside each run, a prefix of the run totals, and their sum;
- the division by the tile size becomes a product with its float32
  reciprocal, and the LLVM backend contracts products into fused
  multiply-adds: the tile coordinate is ``fma(i + 0.5, 1/th, -0.5)``, and
  the blend ``top = fma(wx, l01, (1-wx) l00)``, ``bottom = fma(1-wx, l10,
  wx l11)``, ``out = fma(1-wy, top, wy bottom)``.

A fused multiply-add is taken in float64 and rounded once to float32: the
product of two float32 numbers is exact in float64.  With that order the
plain version is bit-equal to the JAX function on every input the tests
try; K27 (``csrc/clahe.cu``) computes the same, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import kernels

_RUN_EXCESS = 32   # the clip excess: 8 runs of 32 bins
_RUN_CDF = 16      # the cumulative histogram: 16 runs of 16 bins


def _shape(img: torch.Tensor, tiles: int) -> Tuple[int, int]:
    if img.dim() != 2 or img.dtype != torch.uint8:
        raise ValueError(f"clahe: expected a uint8 (H, W) image, got {img.dtype} "
                         f"{tuple(img.shape)}")
    H, W = img.shape
    if tiles < 1 or H < tiles or W < tiles:
        raise ValueError(f"clahe: {tiles} tiles do not fit a {H}x{W} image")
    return H // tiles, W // tiles


def _lut_constants(th: int, tw: int, clip_limit: float):
    """The float32 clip limit and LUT scale of the compiled program."""
    limit = max(1.0, clip_limit * (th * tw) / 256.0)
    return np.float32(limit), np.float32(255.0 / (th * tw))


def _reciprocals(th: int, tw: int):
    """The float32 reciprocals of the tile height and width, by which the
    compiled program multiplies where the JAX source divides."""
    return np.float32(1.0 / th), np.float32(1.0 / tw)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def clahe_lut_plain(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8) -> torch.Tensor:
    """Plain version of K27's first launch: the (tiles, tiles, 256) uint8
    lookup table of every tile."""
    th, tw = _shape(img, tiles)
    limit, scale = _lut_constants(th, tw, clip_limit)
    x = img[:th * tiles, :tw * tiles].to(torch.int64)
    tile = (torch.arange(tiles, device=img.device).repeat_interleave(th)[:, None] * tiles
            + torch.arange(tiles, device=img.device).repeat_interleave(tw)[None, :])
    hist = torch.zeros(tiles * tiles * 256, dtype=torch.int64, device=img.device)
    hist.index_add_(0, (tile * 256 + x).reshape(-1), torch.ones_like(x).reshape(-1))
    hist = hist.reshape(tiles * tiles, 256).to(torch.float32)
    clipped = torch.minimum(hist, torch.tensor(limit, device=img.device))
    over = (hist - clipped).reshape(-1, 256 // _RUN_EXCESS, _RUN_EXCESS)
    run = torch.zeros_like(over[:, :, 0])
    for k in range(_RUN_EXCESS):
        run = run + over[:, :, k]
    excess = torch.zeros_like(run[:, 0])
    for g in range(run.shape[1]):
        excess = excess + run[:, g]
    clipped = (clipped + excess[:, None] * np.float32(1.0 / 256.0)).reshape(
        -1, 256 // _RUN_CDF, _RUN_CDF)
    inner = torch.empty_like(clipped)
    acc = torch.zeros_like(clipped[:, :, 0])
    for k in range(_RUN_CDF):
        acc = acc + clipped[:, :, k]
        inner[:, :, k] = acc
    outer = torch.zeros_like(inner[:, :, 0])
    run_sum = torch.zeros_like(outer[:, 0])
    for g in range(inner.shape[1]):
        outer[:, g] = run_sum
        run_sum = run_sum + inner[:, g, -1]
    cdf = (inner + outer[:, :, None]).reshape(-1, 256)
    lut = torch.clamp(torch.round(cdf * scale), 0, 255)
    return lut.to(torch.uint8).reshape(tiles, tiles, 256)


def _axis(n: int, rcp: np.float32, tiles: int, device):
    """Per row (or column): the lower tile, the upper tile and the weight
    of the upper one."""
    i = torch.arange(n, dtype=torch.float32, device=device) + 0.5
    v = _fma(i, torch.full_like(i, float(rcp)), torch.full_like(i, -0.5))
    lo = torch.clamp(torch.floor(v), 0, tiles - 1).to(torch.int64)
    hi = torch.clamp(lo + 1, max=tiles - 1)
    w = torch.clamp(v - lo.to(torch.float32), 0.0, 1.0)
    return lo, hi, w


def clahe_apply_plain(img: torch.Tensor, lut: torch.Tensor, tiles: int = 8) -> torch.Tensor:
    """Plain version of K27's second launch: the bilinear blend of the four
    neighbouring tiles' LUTs per pixel; the rows and columns past the last
    whole tile are copied unchanged."""
    th, tw = _shape(img, tiles)
    Hc, Wc = th * tiles, tw * tiles
    rcp_h, rcp_w = _reciprocals(th, tw)
    y0, y1, wy = _axis(Hc, rcp_h, tiles, img.device)
    x0, x1, wx = _axis(Wc, rcp_w, tiles, img.device)
    px = img[:Hc, :Wc].to(torch.int64)
    flat = lut.reshape(-1).to(torch.float32)

    def sample(ty, tx):
        return flat[(ty[:, None] * tiles + tx[None, :]) * 256 + px]

    wy, wx = wy[:, None].expand(Hc, Wc), wx[None, :].expand(Hc, Wc)
    owy, owx = 1.0 - wy, 1.0 - wx
    top = _fma(wx, sample(y0, x1), owx * sample(y0, x0))
    bottom = _fma(owx, sample(y1, x0), wx * sample(y1, x1))
    blend = _fma(owy, top, wy * bottom)
    out = img.clone()
    out[:Hc, :Wc] = torch.clamp(torch.round(blend), 0, 255).to(torch.uint8)
    return out


def clahe_plain(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8) -> torch.Tensor:
    """Plain version of ``clahe``."""
    return clahe_apply_plain(img, clahe_lut_plain(img, clip_limit, tiles), tiles)


def clahe_with_lut(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``clahe`` and the tiles' LUTs it blended: (uint8 (H, W), uint8
    (tiles, tiles, 256)).  On a CUDA tensor this launches K27; on the CPU
    it runs the plain versions."""
    th, tw = _shape(img, tiles)
    if not img.is_cuda:
        lut = clahe_lut_plain(img, clip_limit, tiles)
        return clahe_apply_plain(img, lut, tiles), lut
    img = img.contiguous()
    kernels.require_cuda("clahe", img)
    H, W = img.shape
    limit, scale = _lut_constants(th, tw, clip_limit)
    rcp_h, rcp_w = _reciprocals(th, tw)
    lut = torch.empty((tiles, tiles, 256), dtype=torch.uint8, device=img.device)
    out = torch.empty_like(img)
    err = kernels.lib().clahe_launch(img.data_ptr(), H, W, tiles, float(limit), float(scale),
                                     float(rcp_h), float(rcp_w), lut.data_ptr(),
                                     out.data_ptr(), kernels.stream())
    kernels.check(err, "clahe")
    kernels.LAUNCHES["clahe"] += 1
    return out, lut


def clahe(img: torch.Tensor, clip_limit: float = 3.0, tiles: int = 8) -> torch.Tensor:
    """uint8 (H, W) -> uint8 (H, W): CLAHE with ``tiles`` x ``tiles`` tiles
    of H // tiles x W // tiles pixels; the pixels past the last whole tile
    are copied unchanged (as the JAX function does).

    Replaces ``extractorb_tpu/utils/clahe.py:clahe``.  On a CUDA tensor this
    launches K27 (``csrc/clahe.cu``: a CTA per tile builds its LUT, then a
    thread per pixel blends); on the CPU it runs ``clahe_plain``."""
    return clahe_with_lut(img, clip_limit, tiles)[0]
