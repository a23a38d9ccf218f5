"""Padded/masked tensor utilities (port of ``extractorb_tpu/core/padding.py``).

The reference uses dynamically sized std::vectors everywhere; the
package keeps fixed-capacity tensors with validity masks instead, so a
stage's shapes do not depend on its data (SURVEY.md §7 'hard parts').
Plain PyTorch helpers: no kernel of their own.
"""

from __future__ import annotations

import torch

# Sentinel of invalid/padded integer slots.
INVALID = -1


def pad_to(x: torch.Tensor, n: int, fill=0, axis: int = 0) -> torch.Tensor:
    """Pad (or truncate) ``x`` along ``axis`` to length ``n``."""
    cur = x.shape[axis]
    if cur >= n:
        return x.narrow(axis, 0, n)
    shape = list(x.shape)
    shape[axis] = n - cur
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype, device=x.device)], axis)


def masked_top_k(scores: torch.Tensor, mask: torch.Tensor, k: int):
    """Top-k of ``scores`` restricted to ``mask``: (values, int32 indices,
    valid), valid marking slots whose index points at a real entry.  Ties
    go to the lower index, as ``jax.lax.top_k``."""
    neg = torch.finfo(scores.dtype).min
    s = torch.where(mask, scores, torch.tensor(neg, dtype=scores.dtype, device=scores.device))
    vals, idx = torch.sort(s, descending=True, stable=True)
    vals, idx = vals[:k], idx[:k].to(torch.int32)
    return vals, idx, vals > neg


def compact_mask(mask: torch.Tensor, capacity: int):
    """The indices of the True entries, ascending and front-packed into
    ``capacity`` int32 slots padded with INVALID, and the slots' validity."""
    src = torch.nonzero(mask).flatten()[:capacity].to(torch.int32)
    idx = torch.full((capacity,), INVALID, dtype=torch.int32, device=mask.device)
    idx[:src.shape[0]] = src
    return idx, idx >= 0


def gather_rows(x: torch.Tensor, idx: torch.Tensor, fill=0) -> torch.Tensor:
    """x[idx] with the idx == -1 slots replaced by ``fill``."""
    out = x[torch.clamp(idx, min=0).long()]
    m = (idx >= 0).reshape(idx.shape + (1,) * (out.dim() - idx.dim()))
    return torch.where(m, out, torch.tensor(fill, dtype=out.dtype, device=out.device))
