"""CLAHE (``utils/clahe.py``): the port's plain version against the JAX
``clahe`` and against OpenCV's, and on the card kernel K27
(``csrc/clahe.cu``) against the plain version.

The plain version repeats the program XLA:CPU compiles from the JAX
function (its blocked scans, the reciprocal of the tile size and three
fused multiply-adds): the outputs are held bit-equal to JAX's.  The
inputs are those of ``chip_smoke.py`` [parity-clahe]: the procedural
texture at 640x480, 512x512 and 501x753 (rows and columns past the last
whole tile), clip 3.0 and 40 (no clipping), 8 and 4 tiles, a constant
image, plus 320x240 and a seeded noise image.
"""

import functools

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.utils.clahe import clahe as jclahe
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.utils import clahe as tclahe
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

SHAPES = [(480, 640), (512, 512), (501, 753)]
SETTINGS = [(3.0, 8), (40.0, 8), (3.0, 4)]


@functools.lru_cache(maxsize=1)
def texture() -> np.ndarray:
    return pf.procedural_texture()


def image(shape, kind: str = "texture") -> np.ndarray:
    h, w = shape
    if kind == "constant":
        return np.full(shape, 77, np.uint8)
    if kind == "noise":
        return np.random.default_rng(3).integers(0, 256, shape, dtype=np.uint8)
    return np.array(texture()[:h, :w])


CASES = ([(s, "texture", c, t) for s in SHAPES for c, t in SETTINGS]
         + [((240, 320), "texture", 3.0, 8), ((480, 640), "constant", 3.0, 8),
            ((480, 640), "noise", 3.0, 8)])


def case_id(c):
    (h, w), kind, clip, tiles = c
    return f"{kind}-{w}x{h}-clip{clip:g}-tiles{tiles}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_plain_matches_jax(case):
    shape, kind, clip, tiles = case
    img = image(shape, kind)
    want = np.asarray(jclahe(jnp.asarray(img), clip, tiles))
    got = tclahe.clahe_plain(torch.from_numpy(img), clip, tiles).numpy()
    n_diff = int((got != want).sum())
    print(f"{case_id(case)}: {n_diff} of {img.size} pixels differ from JAX")
    assert n_diff == 0
    # the rows and columns past the last whole tile are copied
    hc, wc = shape[0] // tiles * tiles, shape[1] // tiles * tiles
    np.testing.assert_array_equal(got[hc:], img[hc:])
    np.testing.assert_array_equal(got[:, wc:], img[:, wc:])


def test_luts_are_the_ones_blended():
    """``clahe_with_lut`` returns the plain LUTs and the image blended from
    them; on a constant image every tile's LUT maps the value alike, and
    the blend of equal entries is that entry."""
    x = torch.from_numpy(image((512, 512)))
    out, lut = tclahe.clahe_with_lut(x)
    assert lut.shape == (8, 8, 256) and lut.dtype == torch.uint8
    assert torch.equal(lut, tclahe.clahe_lut_plain(x))
    assert torch.equal(out, tclahe.clahe_apply_plain(x, lut))
    out_c, lut_c = tclahe.clahe_with_lut(torch.full((512, 512), 77, dtype=torch.uint8))
    assert (lut_c[:, :, 77] == lut_c[0, 0, 77]).all()
    assert (out_c == lut_c[0, 0, 77]).all()


def test_close_to_cv2():
    """As tests/test_utils.py:11-20 holds the JAX function to
    cv2.createCLAHE(3.0, (8, 8)), on the procedural texture."""
    img = image((480, 640))
    got = tclahe.clahe(torch.from_numpy(img), 3.0, 8).numpy()
    exp = cv2.createCLAHE(3.0, (8, 8)).apply(img)
    diff = np.abs(got.astype(int) - exp.astype(int))
    print(f"vs cv2: mean |diff| {diff.mean():.3f}, median {np.median(diff)}, max {diff.max()}")
    assert diff.mean() < 3.0, diff.mean()
    assert np.median(diff) <= 2
    assert got.std() > img.std()


def test_wrapper_runs_the_plain_version_on_the_cpu():
    img = torch.from_numpy(image((240, 320)))
    before = kernels.LAUNCHES["clahe"]
    assert torch.equal(tclahe.clahe(img), tclahe.clahe_plain(img))
    assert kernels.LAUNCHES["clahe"] == before


def test_rejects_what_it_cannot_take():
    with pytest.raises(ValueError, match="uint8"):
        tclahe.clahe(torch.zeros((64, 64), dtype=torch.float32))
    with pytest.raises(ValueError, match="tiles"):
        tclahe.clahe(torch.zeros((6, 64), dtype=torch.uint8), 3.0, 8)


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_kernel_matches_plain(case, cuda_device):
    shape, kind, clip, tiles = case
    img = torch.from_numpy(image(shape, kind))
    before = kernels.LAUNCHES["clahe"]
    out, lut = tclahe.clahe_with_lut(img.to(cuda_device), clip, tiles)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["clahe"] == before + 1
    want_lut = tclahe.clahe_lut_plain(img, clip, tiles)
    assert torch.equal(lut.cpu(), want_lut)
    assert torch.equal(out.cpu(), tclahe.clahe_apply_plain(img, want_lut, tiles))
