"""Offline viewer (reference Viewer, src/Viewer.cc:130).

The reference runs a Pangolin render loop on its own thread with
follow-camera and menu toggles.  Headless equivalent: attach to a
System, snapshot the frame overlay + map view each tracked frame, and
write PNG frames and (optionally) an MP4 at the end.  No thread — the
host scheduler calls `update()` after each track step, mirroring how
the pipeline stages are driven synchronously everywhere else in this
package.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .frame_drawer import FrameDrawer
from .map_drawer import MapDrawer


class Viewer:
    def __init__(
        self,
        out_dir: str,
        draw_map_every: int = 5,
        map_view: str = "top",
    ):
        os.makedirs(out_dir, exist_ok=True)
        self.out_dir = out_dir
        self.frame_drawer = FrameDrawer()
        self.map_drawer = MapDrawer()
        self.draw_map_every = draw_map_every
        self.map_view = map_view
        self.n = 0
        self._frames = []

    def update(self, system, gray: np.ndarray):
        """Snapshot the current tracking state (call after track_*)."""
        tr = system.tracker
        tr.flush()       # settle pipelined frames (pose may be pending)
        f = tr.last_frame
        if f is None:
            return
        f.ensure_host()  # fused-path frames are device-resident
        mp = tr.atlas.current
        img = self.frame_drawer.update(
            gray,
            kp_xy=np.asarray(f.xy_un),
            kp_valid=np.asarray(f.valid),
            kp_mp=np.asarray(f.kp_mp),
            state=str(tr.state).split(".")[-1],
            n_keyframes=len(mp.keyframes),
            n_map_points=int(mp.mp_valid[: mp._next_mp].sum()),
        )
        self.frame_drawer.save(
            os.path.join(self.out_dir, f"frame_{self.n:06d}.png")
        )
        self._frames.append(img)
        if self.draw_map_every and self.n % self.draw_map_every == 0:
            pose = system.current_pose()
            self.map_drawer.save(
                mp,
                os.path.join(self.out_dir, f"map_{self.n:06d}.png"),
                current_pose=pose,
                view=self.map_view,
            )
        self.n += 1

    def finalize(self, video_name: Optional[str] = "tracking.mp4", fps: int = 15):
        """Write the accumulated overlay frames as a video if imageio
        has an mp4 backend; silently keeps the PNGs otherwise."""
        if not self._frames or video_name is None:
            return None
        path = os.path.join(self.out_dir, video_name)
        try:
            import imageio.v2 as imageio

            imageio.mimwrite(path, self._frames, fps=fps)
            return path
        except Exception:
            return None
