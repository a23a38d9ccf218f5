"""Keyframe-block sharding over the device mesh (port of
``extractorb_tpu/dist/kf_blocks.py``).

The keyframe axis (BoW histograms, descriptor blocks) is split into one
contiguous block per shard; place-recognition scoring runs shard-locally,
and the covisibility-window fetch gathers the requested keyframes' blocks
from whatever shard holds them.  A KF-sharded tensor is a list of blocks,
shard s's on ``mesh.devices[s]`` (``shard_kf_axis``).

``sharded_place_scores`` launches kernel K29 (``csrc/place_dense.cu``)
once per card and query, over every shard whose block lies on that card,
and runs ``place_scores_plain`` on a block on the CPU.
``sharded_loop_candidate_match`` launches K34 (``csrc/kf_match.cu``) once
per shard whose block lies on a card, and ``candidate_match_plain`` on the
CPU.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..frontend.matcher import TH_LOW
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


# the blocks one K29 launch takes (csrc/place_dense.cu kMaxShards)
PLACE_MAX_SHARDS = 64


def place_launch_plan(devices: Sequence[torch.device], rows: Sequence[int]):
    """K29's launches for KF-sharded blocks of ``rows`` rows on ``devices``
    (one of each per shard): one launch per device, in the order in which
    the devices first appear, as (device, [(shard, row0)], total rows) with
    the device's shards in shard order and row0 each block's first row in
    the launch's outputs.  A device with more than ``PLACE_MAX_SHARDS``
    shards takes one launch per group of that many."""
    plan, open_ = [], {}
    for s, (dev, k) in enumerate(zip(devices, rows)):
        dev = torch.device(dev)
        i = open_.get(dev)
        if i is None or len(plan[i][1]) == PLACE_MAX_SHARDS:
            open_[dev] = i = len(plan)
            plan.append((dev, [], 0))
        d, items, total = plan[i]
        plan[i] = (d, items + [(s, total)], total + int(k))
    return plan


def _on_card(t: torch.Tensor, dtype, dev: torch.device) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor; raises unless it is on ``dev``."""
    if t.device != dev:
        raise ValueError(f"place_dense: a block on {t.device}, expected {dev}")
    return t if t.dtype == dtype and t.is_contiguous() else t.to(dtype).contiguous()


def _place_dense(blocks, q, total: int):
    """One K29 launch over ``blocks`` [(hists, has_word, valid)] on one
    card, against ``q`` on that card: scores and counts in one allocation,
    the blocks' rows one after another; returns them split by block."""
    dev, W = q.device, q.shape[0]
    q = _on_card(q, torch.float32, dev)
    vals, rows = [], []
    for h, w, v in blocks:
        h, w, v = (_on_card(h, torch.float32, dev), _on_card(w, torch.bool, dev),
                   _on_card(v, torch.bool, dev))
        k = h.shape[0]
        if h.shape != (k, W) or w.shape != (k, W) or v.shape != (k,):
            raise ValueError("place_dense: inconsistent shapes")
        vals += (h.data_ptr(), w.data_ptr(), v.data_ptr(), k)
        rows.append(k)
    tab = (ctypes.c_longlong * len(vals))(*vals)
    out = torch.empty(2 * total, dtype=torch.float32, device=dev)
    scores, common = out[:total], out[total:].view(torch.int32)
    with torch.cuda.device(dev):
        err = kernels.lib().place_dense_launch(len(rows), tab, W, q.data_ptr(), scores.data_ptr(),
                                               common.data_ptr(), kernels.stream())
    kernels.check(err, "place_dense")
    kernels.LAUNCHES["place_dense"] += 1
    return scores.split(rows), common.split(rows)


def sharded_place_scores(mesh: Mesh, hists, has_word, valid, q_hist):
    """Place-recognition scoring against every stored keyframe: the L1 BoW
    similarity 1 - 0.5 |h - q|_1 (DBoW2's score) and the shared-word
    counts, shard by shard (no cross-shard traffic: the outputs stay
    sharded).  ``hists`` (K, W) float32, ``has_word`` (K, W) bool and
    ``valid`` (K,) bool are KF-sharded; ``q_hist`` (W,) is replicated
    (copied once to each device that holds a shard and lacks it).  On a
    card one K29 launch scores every shard there (``place_launch_plan``),
    into one allocation; on the CPU each shard runs ``place_scores_plain``.
    Returns (scores, common_words), KF-sharded (views of the card's
    allocation); invalid rows score -inf."""
    q = torch.as_tensor(q_hist)
    scores, common = [None] * len(hists), [None] * len(hists)
    on_dev = {}
    for dev, items, total in place_launch_plan([h.device for h in hists],
                                               [h.shape[0] for h in hists]):
        qd = on_dev.get(dev)
        if qd is None:
            qd = on_dev[dev] = q if q.device == dev else q.to(dev)
        if dev.type != "cuda":
            for s, _ in items:
                scores[s], common[s] = place_scores_plain(hists[s], has_word[s], valid[s], qd)
            continue
        sc, cm = _place_dense([(hists[s], has_word[s], valid[s]) for s, _ in items], qd, total)
        for (s, _), a, b in zip(items, sc, cm):
            scores[s], common[s] = a, b
    return scores, common


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


_INF = 1 << 20   # the distance of a masked pair (JAX's)


def _unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 descriptors as (..., 256) float32 bits."""
    shifts = torch.arange(8, device=desc.device, dtype=torch.uint8)
    return ((desc[..., None] >> shifts) & 1).reshape(*desc.shape[:-1], 256).to(torch.float32)


def candidate_match_plain(kf_desc, kf_valid, q_desc, q_valid, chunk: int = 64) -> torch.Tensor:
    """Plain version of one shard's ``sharded_loop_candidate_match``: for
    each keyframe the number of query descriptors whose best keyframe
    descriptor also has them as its best (the lowest index wins a tie; a
    masked pair is at distance 2^20), with distance <= TH_LOW.  The
    Hamming distances are popcount(a) + popcount(b) - 2 a.b over the bits,
    exact in float32.  ``kf_desc`` (Ks, N, 32) uint8, ``kf_valid`` (Ks, N)
    bool, ``q_desc`` (Nq, 32) uint8, ``q_valid`` (Nq,) bool; returns
    (Ks,) int32."""
    qb = _unpack_bits(q_desc)                                       # (Nq, 256)
    qn = qb.sum(-1)
    ar = torch.arange(q_desc.shape[0], device=q_desc.device)
    out = []
    for k0 in range(0, kf_desc.shape[0], chunk):
        kb = _unpack_bits(kf_desc[k0:k0 + chunk])                   # (c, N, 256)
        dist = qn[None, :, None] + kb.sum(-1)[:, None, :] - 2.0 * (qb @ kb.transpose(1, 2))
        ok_pair = q_valid[None, :, None] & kf_valid[k0:k0 + chunk, None, :]
        dm = torch.where(ok_pair, dist.round().to(torch.int32), _INF)    # (c, Nq, N)
        best12 = torch.argmin(dm, dim=2)
        best21 = torch.argmin(dm, dim=1)
        mutual = torch.gather(best21, 1, best12) == ar[None]
        ok = mutual & (dm.min(dim=2).values <= TH_LOW) & q_valid[None]
        out.append(ok.sum(1).to(torch.int32))
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=q_desc.device)
    return torch.cat(out)


def candidate_match(kf_desc, kf_valid, q_desc, q_valid) -> torch.Tensor:
    """One shard's mutual-best match counts: K34 on a card,
    ``candidate_match_plain`` on the CPU."""
    if not kf_desc.is_cuda:
        return candidate_match_plain(kf_desc, kf_valid, q_desc, q_valid)
    Ks, N = kf_desc.shape[0], kf_desc.shape[1]
    Nq = q_desc.shape[0]
    args = [kf_desc.to(torch.uint8).contiguous(), kf_valid.to(torch.bool).contiguous(),
            q_desc.to(torch.uint8).contiguous(), q_valid.to(torch.bool).contiguous()]
    kernels.require_cuda("kf_match", *args)
    if args[0].shape != (Ks, N, 32) or args[1].shape != (Ks, N) or args[2].shape != (Nq, 32) \
            or args[3].shape != (Nq,):
        raise ValueError("kf_match: inconsistent shapes")
    dev = kf_desc.device
    counts = torch.empty(Ks, dtype=torch.int32, device=dev)
    if Ks == 0:
        return counts
    lib = kernels.lib()
    ws = torch.empty(int(lib.kf_match_workspace_bytes(Ks, N, Nq)), dtype=torch.uint8,
                     device=dev)
    with torch.cuda.device(dev):
        err = lib.kf_match_launch(*[a.data_ptr() for a in args], Ks, N, Nq, TH_LOW,
                                  ws.data_ptr(), counts.data_ptr(), kernels.stream())
    kernels.check(err, "kf_match")
    kernels.LAUNCHES["kf_match"] += 1
    return counts


def sharded_loop_candidate_match(mesh: Mesh, kf_desc, kf_valid, q_desc, q_valid):
    """Distributed descriptor matching of a query keyframe against every
    stored keyframe (JAX ``kf_blocks.py:98``): on each shard, for each of
    its keyframes, the number of mutual-best matches with Hamming distance
    <= TH_LOW (``candidate_match``: K34 on a card).  ``kf_desc`` (K, N, 32)
    uint8 and ``kf_valid`` (K, N) bool are KF-sharded (``shard_kf_axis``);
    ``q_desc`` (Nq, 32) uint8 and ``q_valid`` (Nq,) bool are replicated
    (moved to each shard's device here).  Returns the (Ks,) int32 counts
    of each shard.  No engine path calls it."""
    qd, qv = torch.as_tensor(q_desc), torch.as_tensor(q_valid)
    return [candidate_match(d, v, qd.to(d.device), qv.to(d.device))
            for d, v in zip(kf_desc, kf_valid)]


def sharded_loop_candidate_match_plain(mesh: Mesh, kf_desc, kf_valid, q_desc, q_valid):
    """Plain version of ``sharded_loop_candidate_match`` (same arguments)."""
    qd, qv = torch.as_tensor(q_desc), torch.as_tensor(q_valid)
    return [candidate_match_plain(d, v, qd.to(d.device), qv.to(d.device))
            for d, v in zip(kf_desc, kf_valid)]
