"""Keyframe-block sharding over the device mesh (port of
``extractorb_tpu/dist/kf_blocks.py``).

The keyframe axis (BoW histograms, descriptor blocks) is split into one
contiguous block per shard; place-recognition scoring runs shard-locally,
and the covisibility-window fetch gathers the requested keyframes' blocks
from whatever shard holds them.  A KF-sharded tensor is a list of blocks,
shard s's on ``mesh.devices[s]`` (``shard_kf_axis``).

``sharded_place_scores`` launches kernel K29 (``csrc/place_dense.cu``)
once per shard whose block lies on a card, and runs
``place_scores_plain`` on a block on the CPU.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from .mesh import Mesh


def pad_to_mesh(x: np.ndarray, n_dev: int, fill=0) -> np.ndarray:
    """Pad the leading (keyframe) axis to a multiple of the mesh size."""
    K = x.shape[0]
    Kp = ((K + n_dev - 1) // n_dev) * n_dev
    if Kp == K:
        return x
    pad = np.full((Kp - K,) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad], 0)


def shard_kf_axis(mesh: Mesh, x) -> List[torch.Tensor]:
    """Split ``x`` (leading axis a multiple of the mesh size) into one
    contiguous block per shard, each on its shard's device."""
    x = torch.as_tensor(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) else x
    n = mesh.size
    if x.shape[0] % n:
        raise ValueError(f"shard_kf_axis: {x.shape[0]} rows on a mesh of {n}")
    Ks = x.shape[0] // n
    return [x[s * Ks:(s + 1) * Ks].to(dev).contiguous() for s, dev in enumerate(mesh.devices)]


def gather_host(blocks: Sequence[torch.Tensor]) -> np.ndarray:
    """The blocks of a KF-sharded tensor as one host array, in shard order."""
    return np.concatenate([b.cpu().numpy() for b in blocks], 0)


def place_scores_plain(hists, has_word, valid, q_hist) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of one shard's ``sharded_place_scores``."""
    scores = 1.0 - 0.5 * torch.abs(hists - q_hist[None, :]).sum(1)
    common = (has_word & (q_hist > 0)[None, :]).sum(1).to(torch.int32)
    return torch.where(valid, scores, -torch.inf), common


def place_scores(hists, has_word, valid, q_hist) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's L1 BoW scores and shared-word counts: K29 on a card,
    ``place_scores_plain`` on the CPU."""
    if not hists.is_cuda:
        return place_scores_plain(hists, has_word, valid, q_hist)
    K, W = hists.shape
    args = [hists.to(torch.float32).contiguous(), has_word.to(torch.bool).contiguous(),
            valid.to(torch.bool).contiguous(), q_hist.to(torch.float32).contiguous()]
    kernels.require_cuda("place_dense", *args)
    if args[1].shape != (K, W) or args[2].shape != (K,) or args[3].shape != (W,):
        raise ValueError("place_dense: inconsistent shapes")
    scores = torch.empty(K, dtype=torch.float32, device=hists.device)
    common = torch.empty(K, dtype=torch.int32, device=hists.device)
    with torch.cuda.device(hists.device):
        err = kernels.lib().place_dense_launch(*[a.data_ptr() for a in args], K, W,
                                               scores.data_ptr(), common.data_ptr(),
                                               kernels.stream())
    kernels.check(err, "place_dense")
    kernels.LAUNCHES["place_dense"] += 1
    return scores, common


def sharded_place_scores(mesh: Mesh, hists, has_word, valid, q_hist):
    """Place-recognition scoring against every stored keyframe: the L1 BoW
    similarity 1 - 0.5 |h - q|_1 (DBoW2's score) and the shared-word
    counts, shard by shard (no cross-shard traffic: the outputs stay
    sharded).  ``hists`` (K, W) float32, ``has_word`` (K, W) bool and
    ``valid`` (K,) bool are KF-sharded; ``q_hist`` (W,) is replicated
    (moved to each shard's device here).  Returns (scores, common_words),
    KF-sharded; invalid rows score -inf."""
    q = torch.as_tensor(q_hist)
    out = [place_scores(h, w, v, q.to(h.device)) for h, w, v in zip(hists, has_word, valid)]
    return [s for s, _ in out], [c for _, c in out]


def sharded_place_scores_plain(mesh: Mesh, hists, has_word, valid, q_hist):
    """Plain version of ``sharded_place_scores`` (same arguments)."""
    q = torch.as_tensor(q_hist)
    out = [place_scores_plain(h, w, v, q.to(h.device)) for h, w, v in zip(hists, has_word, valid)]
    return [s for s, _ in out], [c for _, c in out]


def all_gather_kf_blocks(mesh: Mesh, blocks, idx):
    """Covisibility-window fetch: the rows ``idx`` (global keyframe indices)
    of a KF-sharded tensor, delivered to every shard's device (the JAX
    function's all_gather).  Copies only.  Returns one (M, ...) tensor per
    shard."""
    full = torch.cat([b.to(mesh.devices[0]) for b in blocks], 0)
    want = torch.as_tensor(idx).to(full.device).long()
    got = full[want]
    return [got.to(dev) for dev in mesh.devices]


def sharded_loop_candidate_match(mesh: Mesh, kf_desc, kf_valid, q_desc, q_valid):
    """Distributed mutual-best descriptor matching of a query against every
    stored keyframe (JAX ``kf_blocks.py:98``).  No engine path calls it."""
    raise NotImplementedError("sharded_loop_candidate_match is not ported (ROADMAP A.14.3)")
