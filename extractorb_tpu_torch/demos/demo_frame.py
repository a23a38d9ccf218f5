"""Frame-construction demo (reference ``frame`` target, src/main_frame.cpp):
the Frame machinery on a 512x512 image through TUM-VI's KB8 fisheye
camera and a BoW vocabulary: extract (K15, K1, K16, K17, K2), no
undistortion for the fisheye, the 64x48 grid (K28), and the BoW transform
(K11), with the reference's >100-keypoint gate (main_frame.cpp:106).  The
grid's cell lookup (PosInGrid) and GetFeaturesInArea around the image
centre are printed beside it.

The JAX demo defaults to a TUM-VI corridor frame; the port's default is
the procedural texture.

Run: python -m extractorb_tpu_torch.demos.demo_frame [--image P] [--vocab P.npz|ORBvoc.txt]
     [--features N] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import KannalaBrandt8
from ..frontend import grid as fg
from ..frontend.extractor import ORBExtractor
from ..place.vocab import Vocabulary, load_orbvoc_text
from ._common import TUM_KB8, default_parser, demo_device, load, orb_config, timer

SHAPE = (512, 512)
AREA_RADIUS = 50.0


def main(argv=None) -> dict:
    p = default_parser(__doc__)
    p.add_argument("--vocab", default=None, help="vocabulary (.npz or ORBvoc.txt)")
    args = p.parse_args(argv)
    dev = demo_device(args)
    img = load(args, SHAPE)
    x = torch.from_numpy(img).to(dev)
    ext = ORBExtractor(orb_config(args, 1500), img.shape, dev)
    ext(x)     # warm-up: the first call on the card loads the kernel library
    with timer(f"extract ({dev.type})", dev):
        feats = ext(x)
    n = int(feats.valid.sum())
    print(f"keypoints: {n}")
    if n <= 100:
        raise SystemExit("reference gate: mvKeys.size() > 100 (main_frame.cpp:106)")

    # KB8 fisheye: keypoints stay raw (the reference keeps mvKeysUn == mvKeys)
    cam = KannalaBrandt8(**TUM_KB8)
    reproj = cam.project(cam.unproject(feats.xy))
    ok = feats.valid
    err = float((reproj[ok] - feats.xy[ok]).abs().max()) if n else 0.0
    print(f"KB8 project(unproject(kp)) max err: {err:.4f} px")

    h, w = img.shape
    bounds = torch.tensor([0.0, float(w), 0.0, float(h)], dtype=torch.float32, device=dev)
    grid, counts = fg.assign_features_to_grid(feats.xy, bounds, feats.valid)
    counts = counts.cpu()
    occ = int((counts > 0).sum())
    print(f"grid: {occ}/{fg.FRAME_GRID_ROWS * fg.FRAME_GRID_COLS} cells occupied, "
          f"max {int(counts.max())} kps/cell")
    _, in_grid = fg.pos_in_grid(feats.xy, bounds, feats.valid)
    print(f"PosInGrid: {int(in_grid.sum())} of {n} keypoints in the grid")
    area = fg.features_in_area_mask(feats.xy, feats.octave, feats.valid, w / 2, h / 2,
                                    AREA_RADIUS, 0, 0)
    n_area = int(area.sum())
    print(f"GetFeaturesInArea(({w / 2:.0f}, {h / 2:.0f}), r={AREA_RADIUS:.0f}, level 0): "
          f"{n_area} keypoints")

    # BoW transform (Frame::ComputeBoW, src/Frame.cc:739-746)
    desc = feats.desc.cpu().numpy()
    valid = feats.valid.cpu().numpy()
    if args.vocab and args.vocab.endswith(".txt"):
        voc = load_orbvoc_text(args.vocab)
    elif args.vocab:
        voc = Vocabulary.load(args.vocab)
    else:
        voc = Vocabulary.train(desc[valid], k=8, L=2, seed=0)
        print("(trained a small on-the-fly vocabulary; pass --vocab for a real one)")
    bow = voc.bow_vector(desc, valid, device=dev)
    nz = int((bow > 0).sum())
    print(f"BoW: {nz} active words of {voc.n_words}")
    return dict(n_keypoints=n, grid=grid.cpu().numpy(), counts=counts.numpy(),
                in_grid=int(in_grid.sum()), n_area=n_area, bow_words=nz)


if __name__ == "__main__":
    main()
