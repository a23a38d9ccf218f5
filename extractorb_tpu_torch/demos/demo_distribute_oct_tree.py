"""Quadtree keypoint-distribution demo (reference distribute_oct_tree,
src/oct_tree/main.cpp): the pyramid, FAST on every level and the
DistributeOctTree balancing, printing each level's candidates before and
after the distribution.

The port runs every level in one launch of each kernel, through the
extractor's plans: the pyramid (K15), FAST with cells and retry (K1), the
per-level top-K collection (K16) and the quadtree with the per-level
compaction to ``budget + 16`` slots (K17); the JAX demo calls the
per-level functions level by level and times each.  "distributed" counts
a level's compacted slots.  The JAX demo also prints OpenCV's ORB count;
the port imports no OpenCV.

Run: python -m extractorb_tpu_torch.demos.demo_distribute_oct_tree [--image P]
     [--features N] [--device cpu]
"""

from __future__ import annotations

import torch

from ..frontend import fast as ffast
from ..frontend.extractor import ORBExtractor, select_keypoints
from ..frontend.pyramid import compute_pyramid
from ._common import default_parser, demo_device, load, orb_config, timer

SHAPE = (480, 640)


def main(argv=None) -> dict:
    args = default_parser(__doc__).parse_args(argv)
    dev = demo_device(args)
    img = load(args, SHAPE)
    x = torch.from_numpy(img).to(dev)
    cfg = orb_config(args, 1000)   # the oct_tree demo's budget
    ext = ORBExtractor(cfg, img.shape, dev)

    def run():
        pyr = compute_pyramid(x, ext.pyr_plan)
        keeps, scores = ffast.fast_detect(pyr, ext.fast_plan, cfg.ini_th_fast, cfg.min_th_fast)
        xy, resp, valid = ffast.collect_levels(keeps, scores, ext.collect_plan)
        return valid, select_keypoints(xy, resp, valid, ext)

    run()      # warm-up: the first call on the card loads the kernel library
    with timer(f"pyramid + FAST + quadtree, {cfg.n_levels} levels ({dev.type})", dev):
        cand, sel = run()
    cand, lvl_valid, depth = cand.cpu(), sel.lvl_valid.cpu(), sel.depth.cpu()
    total, k_off, s_off, rows = 0, 0, 0, []
    for lvl, (k_lvl, cap_l, _) in enumerate(ext.levels):
        n_raw = int(cand[k_off:k_off + k_lvl].sum())
        n_kept = int(lvl_valid[s_off:s_off + cap_l].sum())
        k_off += k_lvl
        s_off += cap_l
        budget = ext.budgets[lvl]
        print(f"level {lvl}: candidates={n_raw} -> distributed={n_kept} "
              f"(budget {budget}, quadtree depth {int(depth[lvl])})")
        total += min(n_kept, budget)
        rows.append((n_raw, n_kept))
    print(f"total distributed keypoints: {total}")
    return dict(total=total, levels=rows)


if __name__ == "__main__":
    main()
