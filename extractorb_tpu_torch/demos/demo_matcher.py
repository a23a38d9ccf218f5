"""Two-frame matcher demo (reference matcher, src/matcher/main_matcher.cpp):
extract two frames (K15, K1, K16, K17, K2), SearchForInitialization's
windowed matching (K3 + K18), the brute-force mutual-best match (the
reference's cv::BFMatcher check, :243-250; K3 both ways), then the
two-view reconstruction (:265-271; K5).

The JAX demo reads two TUM-VI corridor frames; the port's default pair is
the procedural texture on a plane seen by two 512x512 cameras 0.12 m apart
(``_common.texture_pair``), with the approximate pinhole K the JAX demo
puts on the TUM-VI fisheye.

Run: python -m extractorb_tpu_torch.demos.demo_matcher [--img1 P --img2 P]
     [--features N] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from ..frontend import matcher as fm
from ..frontend.extractor import ORBExtractor
from ..geometry import two_view
from ._common import default_parser, demo_device, orb_config, read_image, texture_pair, timer

# TUM-VI 512 fisheye as an approximate pinhole for the H/F model selection
K_PINHOLE = np.array([[190.978, 0, 254.932], [0, 190.973, 256.897], [0, 0, 1]], np.float32)
PAIR_CAP = 512


def main(argv=None) -> dict:
    p = default_parser(__doc__, image=False)
    p.add_argument("--img1", default=None, help="first image (default: the texture pair)")
    p.add_argument("--img2", default=None, help="second image")
    args = p.parse_args(argv)
    dev = demo_device(args)
    if args.img1 and args.img2:
        im1, im2 = read_image(args.img1), read_image(args.img2)
    else:
        im1, im2 = texture_pair(K_PINHOLE.astype(np.float64))
    ext = ORBExtractor(orb_config(args, 1500), im1.shape, dev)
    f1 = ext(torch.from_numpy(im1).to(dev))
    f2 = ext(torch.from_numpy(im2).to(dev))
    n1, n2 = int(f1.valid.sum()), int(f2.valid.sum())
    print(f"keypoints: {n1} / {n2}")
    if n1 <= 100 or n2 <= 100:
        raise SystemExit("reference gate: >100 kps per frame")

    with timer(f"SearchForInitialization ({dev.type})", dev):
        matches = fm.search_for_initialization(
            f1.desc, f1.xy, f1.angle, f1.octave, f1.valid,
            f2.desc, f2.xy, f2.angle, f2.octave, f2.valid)
    matches = matches.cpu().numpy()
    nmatches = int((matches >= 0).sum())
    print(f"SearchForInitialization matches: {nmatches}")

    bf, _ = fm.mutual_best_match(f1.desc, f1.valid, f2.desc, f2.valid)
    n_bf = int((bf >= 0).sum())
    print(f"brute-force mutual-best matches: {n_bf}")

    # two-view reconstruction on the matched pairs
    idx1 = np.where(matches >= 0)[0]
    idx2 = matches[idx1]
    x1 = np.zeros((PAIR_CAP, 2), np.float32)
    x2 = np.zeros((PAIR_CAP, 2), np.float32)
    val = np.zeros(PAIR_CAP, bool)
    k = min(len(idx1), PAIR_CAP)
    x1[:k] = f1.xy.cpu().numpy()[idx1[:k]]
    x2[:k] = f2.xy.cpu().numpy()[idx2[:k]]
    val[:k] = True
    t = lambda a: torch.from_numpy(a).to(dev)
    with timer(f"ReconstructWithTwoViews ({dev.type})", dev):
        res = two_view.reconstruct(two_view.sample_sets(0, t(val)), t(x1), t(x2), t(val),
                                   t(K_PINHOLE))
    ok = bool(res.success)
    n_tri = int(res.is_triangulated.sum())
    R21, t21 = res.R21.cpu().numpy(), res.t21.cpu().numpy()
    print(f"reconstruction: success={ok} model={'H' if bool(res.used_homography) else 'F'} "
          f"triangulated={n_tri}")
    if ok:
        print("R21=\n", R21)
        print("t21=", t21)
    return dict(n1=n1, n2=n2, matches=nmatches, mutual=n_bf, success=ok, triangulated=n_tri,
                R21=R21, t21=t21)


if __name__ == "__main__":
    main()
