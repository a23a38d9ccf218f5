"""The port's demo mains (``extractorb_tpu_torch/demos``), in process on the
CPU with ``--device cpu`` and 300 features, each asserting the key line the
JAX demo prints; and the slice's parity: CLAHE, extraction and the frame
grid through both packages on the same procedural image.

The JAX demos read pictures this repository does not hold; the port's run
on the procedural texture (``demos/_common.py``, a copy of
``port_fixtures.procedural_texture``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.frontend import extractor as jext
from extractorb_tpu.frontend import grid as jgrid
from extractorb_tpu.utils.clahe import clahe as jclahe
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.config import ORBConfig
from extractorb_tpu_torch.demos import (_common, demo_clahe, demo_clahe_keypoint,
                                        demo_distribute_oct_tree, demo_frame, demo_matcher,
                                        demo_orb_extractor, demo_whole_extractor)
from extractorb_tpu_torch.frontend import grid
from extractorb_tpu_torch.frontend.extractor import ORBExtractor
from extractorb_tpu_torch.utils.clahe import clahe
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)

ARGS = ["--features", "300", "--device", "cpu"]
DEMOS = {
    "demo_clahe": (demo_clahe, "output mean/std:"),
    "demo_clahe_keypoint": (demo_clahe_keypoint, "keypoints CLAHE image:"),
    "demo_orb_extractor": (demo_orb_extractor, "descriptors:"),
    "demo_distribute_oct_tree": (demo_distribute_oct_tree, "total distributed keypoints:"),
    "demo_whole_extractor": (demo_whole_extractor, "total keypoints:"),
    "demo_frame": (demo_frame, "grid:"),
    "demo_matcher": (demo_matcher, "SearchForInitialization matches:"),
}


@pytest.mark.parametrize("name", sorted(DEMOS))
def test_demo_runs_on_the_cpu(name, capsys):
    module, key = DEMOS[name]
    out = module.main(ARGS)
    text = capsys.readouterr().out
    assert key in text, text
    assert "import cv2" not in open(module.__file__).read()
    assert isinstance(out, dict)


def test_demo_results():
    """What the demos compute, beyond their printed lines."""
    frame = demo_frame.main(ARGS)
    assert frame["n_keypoints"] > 100
    assert frame["counts"].sum() == frame["in_grid"] == frame["n_keypoints"]
    assert frame["n_area"] > 0 and frame["bow_words"] > 0
    tree = demo_distribute_oct_tree.main(ARGS)
    assert tree["total"] == 300 and all(n_raw >= n for n_raw, n in tree["levels"])
    enhanced = demo_clahe.main(ARGS)
    assert enhanced["enhanced"].std() > enhanced["image"].std()


def test_demo_image_options(tmp_path, capsys):
    img = _common.default_image((240, 320))
    np.save(tmp_path / "in.npy", img)
    demo_clahe.main(["--image", str(tmp_path / "in.npy"), "--out", str(tmp_path / "out.npy"),
                     "--device", "cpu"])
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), clahe(torch.from_numpy(img)))
    demo_clahe_keypoint.main(["--image", str(tmp_path / "in.npy"), "--out",
                              str(tmp_path / "ov"), *ARGS])
    assert (tmp_path / "ov_raw.png").exists() and (tmp_path / "ov_clahe.png").exists()
    assert "written to" in capsys.readouterr().out


def test_default_image_is_the_fixture_texture():
    np.testing.assert_array_equal(_common.procedural_texture(256, seed=1),
                                  pf.procedural_texture(256, seed=1))


def test_slice_parity_with_jax():
    """CLAHE, then extraction and the grid of the enhanced image, through
    both packages: the enhanced images are bit-equal, and both extractors
    read JAX's, so features and grid are bit-equal too."""
    img = np.ascontiguousarray(pf.procedural_texture()[:512, :512])
    jenh = np.array(jclahe(jnp.asarray(img)))
    np.testing.assert_array_equal(clahe(torch.from_numpy(img)).numpy(), jenh)
    cfg = ORBConfig(n_features=300, max_kps_per_level=1024)
    jf = jext.ORBExtractor(cfg, octree="device")(jnp.asarray(jenh))
    tf = ORBExtractor(cfg, (512, 512), "cpu")(torch.from_numpy(jenh))
    got = interop.to_numpy(tf)
    for k in ("xy", "octave", "valid", "desc", "response", "size", "angle"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jf, k)), err_msg=k)
    bounds = np.array([0.0, 512.0, 0.0, 512.0], np.float32)
    jg, jn = jgrid.assign_features_to_grid(jf.xy, jnp.asarray(bounds), jf.valid)
    tg, tn = grid.assign_features_to_grid(tf.xy, torch.from_numpy(bounds), tf.valid)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn.sum()) == int(got["valid"].sum()) > 100
