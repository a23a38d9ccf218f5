"""Whole-extractor demo (reference ``whole_extractor`` target,
src/main_whole_orb_extractor.cpp): the ORB extractor with its per-level
keypoint budgets, quadtree distribution, orientation and descriptors, with
per-level statistics.

The JAX demo runs its host octree (``octree="host"``, the C++
DistributeOctTree in native/octree.cc); the port carries only the device
quadtree (K17), the JAX package's device path, so this demo extracts with
it.  The JAX demo also prints OpenCV's ORB count; the port imports no
OpenCV.

Run: python -m extractorb_tpu_torch.demos.demo_whole_extractor [--image P]
     [--out overlay.png] [--features N] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend.extractor import ORBExtractor
from ._common import default_parser, demo_device, load, orb_config, timer

SHAPE = (480, 640)


def main(argv=None) -> dict:
    args = default_parser(__doc__).parse_args(argv)
    dev = demo_device(args)
    img = load(args, SHAPE)
    x = torch.from_numpy(img).to(dev)
    cfg = orb_config(args, 1000)
    ext = ORBExtractor(cfg, img.shape, dev)
    ext(x)     # warm-up: the first call on the card loads the kernel library
    with timer(f"extract (device octree, {dev.type})", dev):
        feats = ext(x)

    octave = feats.octave.cpu().numpy()
    valid = feats.valid.cpu().numpy()
    print(f"total keypoints: {int(valid.sum())} (budget {cfg.n_features})")
    for lvl in range(cfg.n_levels):
        n_l = int((valid & (octave == lvl)).sum())
        print(f"  level {lvl}: {n_l} kps (budget {ext.budgets[lvl]})")
    desc = feats.desc.cpu().numpy()[valid]
    density = float(np.unpackbits(desc, axis=1).mean()) if len(desc) else 0.0
    print(f"descriptors: {desc.shape[0]} x 256 bits, mean bit density {density:.3f}")

    if args.out:
        from ..viz import FrameDrawer

        fd = FrameDrawer()
        fd.update(img, feats.xy.cpu().numpy(), valid, state="OK")
        fd.save(args.out)
        print(f"wrote {args.out}")
    return dict(n_keypoints=int(valid.sum()), bit_density=density)


if __name__ == "__main__":
    main()
