"""The JAX and the port's System on one rendered stereo or RGB-D sequence,
for ``test_torch_system_stereo.py`` and ``test_torch_system_rgbd.py``, and
the patch that hands the port JAX's random draws."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
import port_fixtures as pf
from extractorb_tpu.config import CameraConfig as JCameraConfig
from extractorb_tpu.config import ORBConfig as JORBConfig
from extractorb_tpu.config import SLAMConfig as JSLAMConfig
from extractorb_tpu.config import TrackingConfig as JTrackingConfig
from extractorb_tpu.slam.system import System as JSystem
from extractorb_tpu_torch.config import TrackingConfig
from extractorb_tpu_torch.geometry import sim3, two_view
from extractorb_tpu_torch.solver import pnp
from test_torch_pnp import jax_pnp_sets
from test_torch_sim3 import jax_sim3_sets
from test_torch_two_view import jax_sets

W, H, NF, N_FRAMES, SPEED, MAX_FRAMES = 320, 240, 1000, 15, 0.04, 8


def patch_jax_draws(m):
    """Make the port draw its two-view, PnP and Sim3 minimal sets as the
    JAX package does from the same integer seed (``m``: a MonkeyPatch)."""
    m.setattr(two_view, "sample_sets",
              lambda seed, valid, n_sets=200: torch.from_numpy(jax_sets(seed, valid, n_sets)
                                                               .copy()))
    m.setattr(pnp, "sample_pnp_sets",
              lambda seed, valid, n_hyp=pnp.N_HYPOTHESES: torch.from_numpy(
                  jax_pnp_sets(seed, np.asarray(valid), n_hyp).astype(np.int64)))
    m.setattr(sim3, "sample_sim3_sets",
              lambda seed, valid, n_hyp=sim3.N_HYPOTHESES: torch.from_numpy(
                  jax_sim3_sets(seed, valid, n_hyp).astype(np.int64)))


def jax_and_port_runs(sensor: str, black=()) -> dict:
    """Both Systems over the same frames (right images or the renderer's
    depth maps), from a cold map; the port on the CPU.  The images at the
    indices in ``black`` (left and right) are black."""
    left, right, depths, poses = pf.render_stereo_sequence(pf.procedural_texture(), N_FRAMES,
                                                           SPEED, W, H)
    left, right = pf.blackout(left, black), pf.blackout(right, black)
    second = right if sensor == "stereo" else depths
    cfg = dataclasses.replace(chip_smoke.stereo_config(sensor, W, H, NF),
                              tracking=TrackingConfig(max_frames=MAX_FRAMES))
    c = cfg.camera
    jcfg = JSLAMConfig(orb=JORBConfig(n_features=NF),
                       camera=JCameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=W, height=H,
                                            bf=c.bf, th_depth=c.th_depth),
                       tracking=JTrackingConfig(max_frames=MAX_FRAMES), sensor=sensor)
    jsys = JSystem(jcfg)
    track = jsys.track_stereo if sensor == "stereo" else jsys.track_rgbd
    jstates, init_points = [], []
    for k, (a, b) in enumerate(zip(left, second)):
        jstates.append(track(a, b, k / 30.0))
        if k == 0:
            init_points.append(jsys.n_map_points())
    jsys.flush()

    def on_frame(k, st, dt, kf_event, sys_):
        if k == 0:
            init_points.append(sys_.n_map_points())

    with pytest.MonkeyPatch.context() as m:
        patch_jax_draws(m)
        psys, pstates = chip_smoke.run_system(left, torch.device("cpu"), on_frame, cfg, second)
    return dict(poses=poses, jsys=jsys, jstates=jstates, psys=psys, pstates=pstates,
                init_points=init_points)
