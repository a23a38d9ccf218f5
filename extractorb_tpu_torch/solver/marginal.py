"""Dense Hessian-block Schur operations (port of
``extractorb_tpu/solver/marginal.py``).

Replaces Optimizer::Marginalize / Condition / Sparsify (reference:
src/Optimizer.cc:5026, :5108, :5128): a solved window's Hessian becomes a
prior on the states that survive.  On CUDA tensors ``marginalize``,
``condition`` and ``sparsify`` launch kernel K36 (``csrc/marginal.cu``:
one CTA a call, the block's pseudo-inverse from a float64 Jacobi
eigen-solve); on the CPU they run their plain versions, which take the
pseudo-inverse from an SVD as the JAX functions do.  The tracking path's
marginalisation runs inside kernel K22 (``csrc/pose_inertial.cu``), whose
plain twin calls ``marginalize_plain``; the JAX engine calls none of
these three functions.
"""

from __future__ import annotations

import torch

from .. import kernels

MAX_BLOCK = 15   # K36's widest block (the inertial states)


def marginalize_plain(H: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Plain version of ``marginalize``."""
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


def condition_plain(H: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Plain version of ``condition``."""
    idx = torch.arange(H.shape[0], device=H.device)
    in_blk = (idx >= start) & (idx <= end)
    mask = ~(in_blk[:, None] | in_blk[None, :])
    return torch.where(mask, H, torch.zeros_like(H))


def sparsify_plain(H: torch.Tensor, start1: int, end1: int, start2: int,
                   end2: int) -> torch.Tensor:
    """Plain version of ``sparsify``."""
    Hac = marginalize_plain(H, start2, end2)
    Hbc = marginalize_plain(H, start1, end1)
    Hc = marginalize_plain(Hac, start1, end1)
    return Hac + Hbc - Hc


def _launch(name: str, mode: int, H: torch.Tensor, blocks) -> torch.Tensor:
    """One K36 launch on a float32 (n, n) H; blocks = (s1, e1, s2, e2)."""
    n = H.shape[0]
    if H.dim() != 2 or H.shape[1] != n or H.dtype != torch.float32:
        raise ValueError(f"{name}: H is {tuple(H.shape)} {H.dtype}, expected (n, n) float32")
    s1, e1, s2, e2 = blocks
    for s, e in ((s1, e1),) if mode < 2 else ((s1, e1), (s2, e2)):
        if not 0 <= s <= e < n:
            raise ValueError(f"{name}: block [{s}, {e}] outside 0..{n - 1}")
        if mode >= 1 and e - s + 1 > MAX_BLOCK:
            raise ValueError(f"{name}: block [{s}, {e}] wider than {MAX_BLOCK}")
    Hc = H.contiguous()
    kernels.require_cuda(name, Hc)
    lib = kernels.lib()
    ws = torch.empty(int(lib.marginal_workspace_bytes(n)), dtype=torch.uint8, device=H.device)
    out = torch.empty_like(Hc)
    err = lib.marginal_launch(Hc.data_ptr(), n, mode, s1, e1, s2, e2, ws.data_ptr(),
                              out.data_ptr(), kernels.stream())
    kernels.check(err, name)
    kernels.LAUNCHES["marginal"] += 1
    kernels.LAUNCHES[name] += 1
    return out


def marginalize(H: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Schur-complement marginalisation of the [start..end] block
    (inclusive), pseudo-inverse with the reference's 1e-6 singular value
    cutoff.  Rows and columns of the marginalised block come back zero.
    On CUDA tensors (float32, blocks up to 15 wide) this launches K36."""
    if not H.is_cuda:
        return marginalize_plain(H, start, end)
    return _launch("marginal_marginalize", 1, H, (start, end, 0, 0))


def condition(H: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """Zero the rows and columns of the [start..end] block (reference
    Optimizer::Condition, :5108): its information is dropped, not
    transferred.  On CUDA tensors (float32) this launches K36."""
    if not H.is_cuda:
        return condition_plain(H, start, end)
    return _launch("marginal_condition", 0, H, (start, end, 0, 0))


def sparsify(H: torch.Tensor, start1: int, end1: int, start2: int, end2: int) -> torch.Tensor:
    """Remove the information link between blocks 1 and 2 (reference
    Optimizer::Sparsify, :5128): marg(H, 2) + marg(H, 1) - marg(marg(H, 2), 1).
    On CUDA tensors (float32, blocks up to 15 wide) this launches K36 once."""
    if not H.is_cuda:
        return sparsify_plain(H, start1, end1, start2, end2)
    return _launch("marginal_sparsify", 2, H, (start1, end1, start2, end2))
