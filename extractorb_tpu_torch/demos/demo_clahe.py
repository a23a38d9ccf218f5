"""Bare CLAHE demo (reference clahe, src/clahe/main_clahe.cpp:7-11): clip
limit 3.0, 8x8 tiles, on a 640x480 image, through K27 on the card.

The JAX demo also prints its distance to OpenCV's CLAHE; the port imports
no OpenCV, and tests/test_torch_clahe.py holds it to cv2.createCLAHE.

Run: python -m extractorb_tpu_torch.demos.demo_clahe [--image P] [--out enhanced.png]
     [--device cpu]
"""

from __future__ import annotations

import torch

from ..utils.clahe import clahe
from ._common import default_parser, demo_device, load, timer, write_image

SHAPE = (480, 640)


def main(argv=None) -> dict:
    args = default_parser(__doc__).parse_args(argv)
    dev = demo_device(args)
    img = load(args, SHAPE)
    x = torch.from_numpy(img).to(dev)
    clahe(x)   # warm-up: the first call on the card loads the kernel library
    with timer(f"CLAHE ({dev.type})", dev):
        out = clahe(x)
    out = out.cpu().numpy()
    print(f"input  mean/std: {img.mean():.1f} / {img.std():.1f}")
    print(f"output mean/std: {out.mean():.1f} / {out.std():.1f}")
    if args.out:
        write_image(args.out, out)
        print(f"written to {args.out}")
    return dict(image=img, enhanced=out)


if __name__ == "__main__":
    main()
