"""Full ORB extractor demo (reference ORB_SLAM_Extractor,
src/orb_extractor/main_orb_extractor.cpp): CLAHE with timing, the full
extraction pass (pyramid K15 -> FAST K1 -> top-K K16 -> quadtree K17 ->
orientation and descriptors K2) with timing, and per-level keypoint
counts.  The JAX demo also prints OpenCV's ORB count beside them; the port
imports no OpenCV.

Run: python -m extractorb_tpu_torch.demos.demo_orb_extractor [--image P] [--out overlay.png]
     [--features N] [--device cpu]
"""

from __future__ import annotations

import torch

from ..frontend.extractor import ORBExtractor
from ..utils.clahe import clahe
from ._common import default_parser, demo_device, load, orb_config, timer

SHAPE = (480, 640)


def main(argv=None) -> dict:
    args = default_parser(__doc__).parse_args(argv)
    dev = demo_device(args)
    img = load(args, SHAPE)
    x = torch.from_numpy(img).to(dev)

    # CLAHE timing (reference main_orb_extractor.cpp:19-25)
    clahe(x)   # warm-up: the first call on the card loads the kernel library
    with timer(f"CLAHE ({dev.type})", dev):
        clahe(x)

    cfg = orb_config(args, 1500)
    ext = ORBExtractor(cfg, img.shape, dev)
    ext(x)     # warm-up
    with timer(f"ORB extract ({dev.type})", dev):
        feats = ext(x)

    valid = feats.valid.cpu().numpy()
    octv = feats.octave.cpu().numpy()[valid]
    print(f"keypoints: {int(valid.sum())}")
    per_level = [int((octv == lvl).sum()) for lvl in range(cfg.n_levels)]
    for lvl, n in enumerate(per_level):
        print(f"  level {lvl}: {n}")
    desc = feats.desc.cpu().numpy()[valid]
    print(f"descriptors: {desc.shape} uint8 ({desc.shape[1] * 8} bits)")

    if args.out:
        from ..viz import FrameDrawer

        fd = FrameDrawer()
        fd.update(img, feats.xy.cpu().numpy(), valid, state="OK")
        fd.save(args.out)
        print(f"overlay written to {args.out}")
    return dict(n_keypoints=int(valid.sum()), per_level=per_level)


if __name__ == "__main__":
    main()
