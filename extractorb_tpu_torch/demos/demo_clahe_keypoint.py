"""Extractor on the raw and the CLAHE-enhanced image (reference
clahe_img_keypoint, src/clahe/main_show_clahe_keypoint.cpp:19-25): the
reference displays both keypoint sets side by side; here the counts are
printed and ``--out PREFIX`` writes both overlays.

Run: python -m extractorb_tpu_torch.demos.demo_clahe_keypoint [--image P] [--out prefix]
     [--features N] [--device cpu]
"""

from __future__ import annotations

import torch

from ..frontend.extractor import ORBExtractor
from ..utils.clahe import clahe
from ._common import default_parser, demo_device, load, orb_config

SHAPE = (480, 640)


def main(argv=None) -> dict:
    args = default_parser(__doc__).parse_args(argv)
    dev = demo_device(args)
    img = load(args, SHAPE)
    x = torch.from_numpy(img).to(dev)
    ext = ORBExtractor(orb_config(args, 1500), img.shape, dev)
    enhanced = clahe(x)
    f_raw = ext(x)
    f_enh = ext(enhanced)
    n_raw = int(f_raw.valid.sum())
    n_enh = int(f_enh.valid.sum())
    print(f"keypoints raw image:   {n_raw}")
    print(f"keypoints CLAHE image: {n_enh}")
    if args.out:
        from ..viz import FrameDrawer

        fd = FrameDrawer()
        fd.update(img, f_raw.xy.cpu().numpy(), f_raw.valid.cpu().numpy())
        fd.save(f"{args.out}_raw.png")
        fd.update(enhanced.cpu().numpy(), f_enh.xy.cpu().numpy(), f_enh.valid.cpu().numpy())
        fd.save(f"{args.out}_clahe.png")
        print(f"overlays: {args.out}_raw.png, {args.out}_clahe.png")
    return dict(n_raw=n_raw, n_clahe=n_enh)


if __name__ == "__main__":
    main()
