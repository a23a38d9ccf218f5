"""Dense Hessian-block Schur operations (port of
``extractorb_tpu/solver/marginal.py``).

Replaces Optimizer::Marginalize / Condition / Sparsify (reference:
src/Optimizer.cc:5026, :5108, :5128): a solved window's Hessian becomes a
prior on the states that survive.  Plain PyTorch: the only caller on the
tracking path, ``optimize_pose_inertial_last_frame``, runs its
marginalisation inside kernel K22 (``csrc/pose_inertial.cu``);
``condition`` and ``sparsify`` have no caller in the engine and no kernel
yet (ROADMAP B.33).
"""

from __future__ import annotations

import torch


def marginalize(H: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Schur-complement marginalisation of the [start..end] block
    (inclusive), SVD pseudo-inverse with the reference's 1e-6 singular
    value cutoff.  Rows and columns of the marginalised block come back
    zero."""
    n = H.shape[0]
    dev = H.device
    keep = torch.cat([torch.arange(0, start, device=dev), torch.arange(end + 1, n, device=dev)])
    marg = torch.arange(start, end + 1, device=dev)
    Haa = H[keep][:, keep]
    Hab = H[keep][:, marg]
    Hba = H[marg][:, keep]
    Hbb = H[marg][:, marg]
    U, s, Vh = torch.linalg.svd(Hbb)
    s_inv = torch.where(s > 1e-6, 1.0 / torch.where(s > 1e-6, s, torch.ones_like(s)),
                        torch.zeros_like(s))
    Hbb_pinv = (Vh.transpose(-1, -2) * s_inv[None, :]) @ U.transpose(-1, -2)
    out = torch.zeros_like(H)
    out[keep[:, None], keep[None, :]] = Haa - Hab @ Hbb_pinv @ Hba
    return out


def condition(H: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Zero the rows and columns of the [start..end] block (reference
    Optimizer::Condition, :5108): its information is dropped, not
    transferred."""
    idx = torch.arange(H.shape[0], device=H.device)
    in_blk = (idx >= start) & (idx <= end)
    mask = ~(in_blk[:, None] | in_blk[None, :])
    return torch.where(mask, H, torch.zeros_like(H))


def sparsify(H: torch.Tensor, start1: int, end1: int, start2: int, end2: int) -> torch.Tensor:
    """Remove the information link between blocks 1 and 2 (reference
    Optimizer::Sparsify, :5128): marg(H, 2) + marg(H, 1) - marg(marg(H, 2), 1)."""
    Hac = marginalize(H, start2, end2)
    Hbc = marginalize(H, start1, end1)
    Hc = marginalize(Hac, start1, end1)
    return Hac + Hbc - Hc
