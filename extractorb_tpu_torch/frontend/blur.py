"""7x7 sigma=2 Gaussian blur before descriptor sampling
(port of ``extractorb_tpu/frontend/blur.py``).

OpenCV's bit-exact fixed-point path for CV_8U: taps
[18, 34, 48, 56, 48, 34, 18] / 256 per axis, exact integer sums, final
rounding ``(acc + 2^15) >> 16``.  This is the plain version; kernel K2
(``brief.orb_describe``) blurs only the patch around each keypoint, in
shared memory, and never forms the blurred level.
"""

from __future__ import annotations

import torch

TAPS = (18, 34, 48, 56, 48, 34, 18)


def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    """Bit-exact cv2.GaussianBlur(img, (7,7), 2) for uint8; rolls wrap at
    the edges, so only pixels >= 3 from the edge are valid (callers pass
    bordered images whose reflect-101 ring supplies the border reads)."""
    x = img.to(torch.int32)
    rows = sum(k * torch.roll(x, 3 - i, dims=1) for i, k in enumerate(TAPS))
    acc = sum(k * torch.roll(rows, 3 - j, dims=0) for j, k in enumerate(TAPS))
    return ((acc + 32768) >> 16).clamp(0, 255).to(torch.uint8)


def blur_level(bordered: torch.Tensor, border: int = 19) -> torch.Tensor:
    """Blur the inner region of a bordered pyramid level; the border ring
    stays unblurred (the reference blurs only the inner view)."""
    h, w = bordered.shape
    out = bordered.clone()
    out[border:h - border, border:w - border] = \
        gaussian_blur7(bordered)[border:h - border, border:w - border]
    return out
