"""Keypoint undistortion (``core/camera.py``): the port's plain version
against the JAX ``undistort_points_pinhole``, and on the card kernel K24
(``csrc/undistort.cu``) against the plain version.

The camera is TUM fr1's (ORB-SLAM3 ``Examples/Monocular/TUM1.yaml``, the
``FR1`` of ``tests/test_camera.py``): strong radial terms (k1 0.26, k2
-0.95, k3 1.16).  The JAX package runs on XLA:CPU, which contracts
multiply-adds into FMAs, so the CPU parity is held to 1e-4 px; the kernel
repeats the plain version's float32 operations one by one and is held to
it bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.core import camera as jcamera
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.core import camera
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

N = 2048


def fr1(width: int = 640, height: int = 480):
    K = pf.fr1_camera_matrix(width, height)
    return K, camera.Pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), pf.FR1_DIST


def keypoints(seed: int = 0, n: int = N, width: int = 640, height: int = 480) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform([0.0, 0.0], [width, height], (n, 2)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax(seed):
    K, cam, dist = fr1()
    uv = keypoints(seed)
    jcam = jcamera.Pinhole(float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]))
    want = np.asarray(jcamera.undistort_points_pinhole(jnp.asarray(uv), jcam, dist))
    got = camera.undistort_points_pinhole_plain(torch.from_numpy(uv), cam, dist).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_wrapper_runs_the_plain_version_on_the_cpu():
    _, cam, dist = fr1()
    uv = torch.from_numpy(keypoints(2))
    before = kernels.LAUNCHES["undistort"]
    assert torch.equal(camera.undistort_points_pinhole(uv, cam, dist),
                       camera.undistort_points_pinhole_plain(uv, cam, dist))
    assert kernels.LAUNCHES["undistort"] == before


def test_inverts_the_distortion_of_the_renderer():
    """The 8 fixed compensation steps undo the distortion that the
    renderer inverts by Newton's method to convergence: within 0.01 px in
    the image centre, and within 1 px out to the corners of the 640x480
    image (where cv::undistortPoints' fixed step count has not converged)."""
    K, cam, dist = fr1()
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.62, 0.62, 4000)
    y = rng.uniform(-0.5, 0.5, 4000)
    xd, yd = pf.distort_normalized(x, y, dist)
    uv = np.stack([K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]], -1).astype(np.float32)
    got = camera.undistort_points_pinhole_plain(torch.from_numpy(uv), cam, dist).numpy()
    want = np.stack([K[0, 0] * x + K[0, 2], K[1, 1] * y + K[1, 2]], -1)
    err = np.linalg.norm(got - want, axis=1)
    centre = x * x + y * y < 0.1
    assert err[centre].max() < 0.01, err[centre].max()
    assert err.max() < 1.0, err.max()


def test_undistort_then_distort_roundtrip():
    """``pf.undistort_normalized`` (the renderer's Newton inverse) returns
    points that distort back to their input to 1e-12."""
    rng = np.random.default_rng(4)
    xd, yd = rng.uniform(-0.6, 0.6, 1000), rng.uniform(-0.5, 0.5, 1000)
    x, y = pf.undistort_normalized(xd, yd, pf.FR1_DIST)
    bx, by = pf.distort_normalized(x, y, pf.FR1_DIST)
    assert max(np.abs(bx - xd).max(), np.abs(by - yd).max()) < 1e-12


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1128, N, 1])
def test_kernel_matches_plain_bit_for_bit(cuda_device, n):  # noqa: F811
    _, cam, dist = fr1()
    uv = torch.from_numpy(keypoints(5, n)).to(cuda_device)
    before = kernels.LAUNCHES["undistort"]
    got = camera.undistort_points_pinhole(uv, cam, dist)
    want = camera.undistort_points_pinhole_plain(uv, cam, dist)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["undistort"] == before + 1
    assert torch.equal(got, want), float((got - want).abs().max())
    # and the plain version computes the same on the card as on the CPU
    assert torch.equal(want.cpu(), camera.undistort_points_pinhole_plain(uv.cpu(), cam, dist))


@pytest.mark.gpu
def test_kernel_refuses_other_shapes_and_types(cuda_device):  # noqa: F811
    _, cam, dist = fr1()
    with pytest.raises(ValueError, match="undistort"):
        camera.undistort_points_pinhole(torch.zeros(4, 3, device=cuda_device), cam, dist)
    with pytest.raises(ValueError, match="undistort"):
        camera.undistort_points_pinhole(torch.zeros(4, 2, dtype=torch.float64,
                                                    device=cuda_device), cam, dist)
