"""Robust kernels as IRLS weights (port of ``extractorb_tpu/solver/robust.py``)."""

from __future__ import annotations

import torch

# chi2 thresholds (2 dof mono, 3 dof stereo) used across the reference
CHI2_MONO = 5.991
CHI2_STEREO = 7.815
DELTA_MONO = CHI2_MONO ** 0.5
DELTA_STEREO = CHI2_STEREO ** 0.5


def huber_weight(chi2: torch.Tensor, delta) -> torch.Tensor:
    """IRLS weight for the Huber kernel: w = min(1, delta / sqrt(chi2))."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.clamp(delta / e, max=1.0)
