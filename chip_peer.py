"""The device mesh's peer route on several cards.

    python3 chip_peer.py        # on a machine with two or more cards

``chip_smoke.py`` runs the mesh as 4 shards of one card, where the shards'
partial sums meet in one kernel.  With shards on distinct cards the sums
go by peer copies to shard 0's card (``csrc/shard_sum.cuh``); this script
runs that route: [loop-mesh] over every visible card, then K30 (the
[loop] map's GBA and a noisy problem) and K31 (a 200-keyframe essential
graph, both ``fix_scale``) on one shard per card, then [vi-loop-mesh] over
every visible card with K32 on its post-loop GBA (the one-view points
fixed) and K33 (the [loop] map's problem, its points moved by 1 cm, and a
noisy one), each against its plain version, against the same number of
shards on one card (bit-equal: the same sums in the same order), 20 calls
for one result, and timed beside the one-card route.  Fails without two
cards.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import chip_smoke as cs  # noqa: E402
from extractorb_tpu_torch.dist import global_ba, sharded_ba  # noqa: E402
from extractorb_tpu_torch.dist import mesh as dmesh  # noqa: E402
from extractorb_tpu_torch.dist import sharded_pose_graph as dpg  # noqa: E402


def main() -> int:
    cs.phase_environment()
    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"chip_peer.py needs two or more cards, found {n}")
    cs.phase_build()
    dev = torch.device("cuda", 0)
    t0 = time.time()
    cs.phase_loop_mesh(dev)
    print(f"[peer] loop-mesh {time.time() - t0:.1f} s", flush=True)
    cards = dmesh.Mesh([torch.device("cuda", i) for i in range(n)])
    one = dmesh.Mesh([dev] * n)
    cam = cs.loop_camera()
    mp = cs.looped_map(dev)[0]
    gp = global_ba.build_global_problem(mp, [1.0] * 8, n, None, dev)[0]
    gp1 = global_ba.build_global_problem(mp, [1.0] * 8, 1, None, dev)[0]
    rng = np.random.default_rng(3)
    noisy = sharded_ba.relayout_for_schur(
        cs.ba_problem(rng, dev, n_kf=24, n_pts=700, Kp=24, Pp=768, Op=24 * 700), n)
    for name, p in (("[loop] map", gp), ("noisy", noisy)):
        bc = sharded_ba.optimize_schur(p, cam, mesh=cards)
        bo = sharded_ba.optimize_schur(p, cam, mesh=one)
        bp = sharded_ba.optimize_schur_plain(p, cam, mesh=cards)
        same = all(torch.equal(getattr(bc, f).cpu(), getattr(bo, f).cpu()) for f in bc._fields)
        print(f"[peer] ba_schur_sharded {name} on {n} cards: {cs._ba_dist(bc, bp):.2e} from "
              f"plain, inliers equal {torch.equal(bc.inliers, bp.inliers)}, cost "
              f"{float(bc.cost):.6g} / {float(bp.cost):.6g}; bit-equal to {n} shards of one "
              f"card: {same}", flush=True)
        res = [tuple(t.cpu() for t in sharded_ba.optimize_schur(p, cam, mesh=cards))
               for _ in range(20)]
        k = cs._distinct(res)
        print(f"[peer] ba_schur_sharded {name}: {k} distinct of 20", flush=True)
        if not (same and k == 1 and cs._ba_dist(bc, bp) <= 1e-3
                and torch.equal(bc.inliers, bp.inliers)):
            raise AssertionError(f"ba_schur_sharded ({name}) on {n} cards")
        ms_c = cs.cuda_ms(lambda: sharded_ba.optimize_schur(p, cam, mesh=cards), reps=5)
        ms_o = cs.cuda_ms(lambda: sharded_ba.optimize_schur(p, cam, mesh=one), reps=5)
        print(f"[peer] ba_schur_sharded {name}: {ms_c:.3f} ms on {n} cards, {ms_o:.3f} ms on "
              f"{n} shards of one card", flush=True)
    pg = cs.pad_graph(cs.pose_graph_problem(rng, dev), n)
    for fix in (False, True):
        gc = dpg.optimize_sharded_pose_graph(cards, pg, fix_scale=fix)
        go = dpg.optimize_sharded_pose_graph(one, pg, fix_scale=fix)
        g64 = dpg.optimize_sharded_pose_graph_plain(cards, cs.graph_f64(pg), fix_scale=fix)
        d = max(float((a.double() - b).abs().max()) for a, b in zip(gc[:3], g64[:3]))
        same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(gc, go))
        print(f"[peer] pose_graph_sharded fix_scale={fix} on {n} cards: {d:.2e} from the "
              f"float64 plain; bit-equal to {n} shards of one card: {same}", flush=True)
        if not (same and d <= 1e-4):
            raise AssertionError(f"pose_graph_sharded fix_scale={fix} on {n} cards")
    res = [tuple(t.cpu() for t in dpg.optimize_sharded_pose_graph(cards, pg)) for _ in range(20)]
    k = cs._distinct(res)
    print(f"[peer] pose_graph_sharded: {k} distinct of 20", flush=True)
    if k != 1:
        raise AssertionError(f"pose_graph_sharded on {n} cards: {k} distinct results")
    ms_c = cs.cuda_ms(lambda: dpg.optimize_sharded_pose_graph(cards, pg), reps=5)
    ms_o = cs.cuda_ms(lambda: dpg.optimize_sharded_pose_graph(one, pg), reps=5)
    print(f"[peer] pose_graph_sharded: {ms_c:.3f} ms on {n} cards, {ms_o:.3f} ms on {n} shards "
          f"of one card", flush=True)

    # K32: [vi-loop-mesh] over the cards, then its GBA call on both routes
    _, (vmesh, vprob, vcam, vkw) = cs.phase_vi_loop_mesh(dev)
    vprob = cs.one_view_fixed(vprob)
    vc = sharded_ba.optimize_vi_sharded(cards, vprob, vcam, **vkw)
    vo = sharded_ba.optimize_vi_sharded(one, vprob, vcam, **vkw)
    vp = cs.sin.optimize_vi_ba_plain(vprob, vcam, mesh=cards, **vkw)
    same = all(torch.equal(getattr(vc, f).cpu(), getattr(vo, f).cpu()) for f in vc._fields)
    res = [tuple(t.cpu() for t in sharded_ba.optimize_vi_sharded(cards, vprob, vcam, **vkw))
           for _ in range(20)]
    k, d = cs._distinct(res), cs.vi_dist(vc, vp)
    print(f"[peer] vi_ba_sharded [vi-loop-mesh] GBA on {vmesh.size} shards ({n} cards): {d:.2e} "
          f"from plain, inliers equal {torch.equal(vc.inliers.cpu(), vp.inliers.cpu())}; "
          f"bit-equal to {n} shards of one card: {same}; {k} distinct of 20", flush=True)
    if not (same and k == 1 and d <= 1e-4 and torch.equal(vc.inliers.cpu(), vp.inliers.cpu())):
        raise AssertionError(f"vi_ba_sharded on {n} cards")
    ms_c = cs.cuda_ms(lambda: sharded_ba.optimize_vi_sharded(cards, vprob, vcam, **vkw), reps=3)
    ms_o = cs.cuda_ms(lambda: sharded_ba.optimize_vi_sharded(one, vprob, vcam, **vkw), reps=3)
    print(f"[peer] vi_ba_sharded: {ms_c:.3f} ms on {n} cards, {ms_o:.3f} ms on {n} shards of "
          f"one card", flush=True)

    # K33: the [loop] map's problem (points moved by 1 cm) and a noisy one
    noise = torch.from_numpy(np.random.default_rng(17).normal(
        0, 0.01, tuple(gp1.points.shape)).astype(np.float32)).to(dev)
    moved = gp1._replace(points=gp1.points + noise * (~gp1.fixed_mp)[:, None])
    noisy = cs.ba_problem(rng, dev, n_kf=24, n_pts=700, Kp=24, Pp=700, Op=24 * 700)
    for name, p in (("[loop] map, points moved 1 cm", moved), ("noisy", noisy)):
        bc = sharded_ba.optimize_sharded(cards, p, cam)
        bo = sharded_ba.optimize_sharded(one, p, cam)
        bp = sharded_ba.optimize_sharded_plain(cards, p, cam)
        same = all(torch.equal(getattr(bc, f).cpu(), getattr(bo, f).cpu()) for f in bc._fields)
        res = [tuple(t.cpu() for t in sharded_ba.optimize_sharded(cards, p, cam))
               for _ in range(20)]
        k = cs._distinct(res)
        print(f"[peer] ba_pcg_sharded {name} on {n} cards: {cs._ba_dist(bc, bp):.2e} from plain, "
              f"inliers equal {torch.equal(bc.inliers.cpu(), bp.inliers.cpu())}, cost "
              f"{float(bc.cost):.6g} / {float(bp.cost):.6g}; bit-equal to {n} shards of one "
              f"card: {same}; {k} distinct of 20", flush=True)
        if not (same and k == 1 and torch.equal(bc.inliers.cpu(), bp.inliers.cpu())
                and (name != "noisy" or cs._ba_dist(bc, bp) <= 1e-4)):
            raise AssertionError(f"ba_pcg_sharded ({name}) on {n} cards")
        ms_c = cs.cuda_ms(lambda: sharded_ba.optimize_sharded(cards, p, cam), reps=5)
        ms_o = cs.cuda_ms(lambda: sharded_ba.optimize_sharded(one, p, cam), reps=5)
        print(f"[peer] ba_pcg_sharded {name}: {ms_c:.3f} ms on {n} cards, {ms_o:.3f} ms on {n} "
              f"shards of one card", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
