"""The port's offline visualisation (``viz/``) against the JAX package's:
the frame overlay bit-equal on the same inputs, the frustum and
covisibility segments equal on ``port_fixtures.build_looped_map`` carried
across with ``interop``, the map render's shape, and the ``Viewer`` over a
6-frame port ``System`` run on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.frontend.extractor import Features as JFeatures
from extractorb_tpu.slam.map import KeyFrame as JKeyFrame
from extractorb_tpu.slam.map import SLAMMap as JSLAMMap
from extractorb_tpu.viz import FrameDrawer as JFrameDrawer
from extractorb_tpu.viz import map_drawer as jmap_drawer
from extractorb_tpu_torch import interop
from extractorb_tpu_torch.viz import FrameDrawer, MapDrawer, Viewer, map_drawer
from torch_card import one_torch_thread  # noqa: F401  (pytest fixture)


def jfeats(d, xy, v):
    n = len(v)
    return JFeatures(xy=jnp.asarray(xy), response=jnp.zeros(n), angle=jnp.zeros(n),
                     octave=jnp.zeros(n, jnp.int32), size=jnp.full(n, 31.0),
                     desc=jnp.asarray(d), valid=jnp.asarray(v))


@pytest.fixture(scope="module")
def maps():
    """The JAX looped map and the port's copy of it."""
    jmp = pf.build_looped_map(0, JSLAMMap, JKeyFrame, jfeats, n_kf=6, n_pts=80)[0]
    return jmp, interop.map_from_numpy(interop.map_to_numpy(jmp), "cpu")


@pytest.mark.parametrize("with_extras", [False, True], ids=["plain", "map-points-and-matches"])
def test_frame_drawer_matches_jax(with_extras):
    rng = np.random.default_rng(0)
    gray = rng.integers(0, 200, (480, 640), dtype=np.uint8)
    n = 60
    xy = np.stack([rng.uniform(-5, 645, n), rng.uniform(-5, 485, n)], -1).astype(np.float32)
    valid = rng.random(n) > 0.2
    kw = dict(state="OK", n_keyframes=7, n_map_points=1234)
    if with_extras:
        kw.update(kp_mp=np.where(np.arange(n) % 2 == 0, np.arange(n), -1),
                  init_matches=[(xy[i], xy[i] + rng.uniform(-30, 30, 2)) for i in range(10)],
                  state="NOT_INITIALIZED")
    want = JFrameDrawer().update(gray, xy, valid, **kw)
    got = FrameDrawer().update(gray, xy, valid, **kw)
    assert got.shape == (492, 640, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_frustum_and_covisibility_segments_match_jax(maps):
    jmp, mp = maps
    for kid, kf in mp.keyframes.items():
        np.testing.assert_array_equal(map_drawer.frustum_segments(kf.R, kf.t),
                                      jmap_drawer.frustum_segments(jmp.keyframes[kid].R,
                                                                   jmp.keyframes[kid].t))
    for w in (5, 15):
        got = map_drawer.covisibility_segments(mp, min_weight=w)
        np.testing.assert_array_equal(got, jmap_drawer.covisibility_segments(jmp, min_weight=w))
    assert got.shape[0] > 0 and got.shape[0] % 2 == 0


def test_map_drawer_render(maps):
    _, mp = maps
    kf = mp.keyframes[max(mp.keyframes)]
    img = MapDrawer().render(mp, current_pose=(kf.R, kf.t), view="side", figsize=(3, 3))
    assert img.shape == (300, 300, 3) and img.dtype == np.uint8
    assert (img < 250).mean() > 0.01


def test_viewer_over_a_system_run(tmp_path):
    import chip_smoke
    from extractorb_tpu_torch.slam.system import System

    frames, _, _ = pf.render_sequence(pf.procedural_texture(), 6, 0.04, 320, 240)
    sys_ = System(chip_smoke.system_config(320, 240, 300), device="cpu")
    viewer = Viewer(str(tmp_path), draw_map_every=5)
    for k, img in enumerate(frames):
        sys_.track_monocular(img, k / 30.0)
        viewer.update(sys_, img)
    assert viewer.n == 6
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == [f"frame_{k:06d}.png" for k in range(6)] + ["map_000000.png",
                                                                  "map_000005.png"]
    import imageio.v2 as imageio

    frame = imageio.imread(tmp_path / "frame_000005.png")
    assert frame.shape == (240 + 12, 320, 3)
    np.testing.assert_array_equal(frame, viewer._frames[-1])
    assert viewer.finalize(video_name=None) is None
