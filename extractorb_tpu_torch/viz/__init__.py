"""Offline visualization (reference L7: src/FrameDrawer.cc,
src/MapDrawer.cc, src/Viewer.cc; a copy of ``extractorb_tpu/viz``).  The
reference renders live through Pangolin/OpenGL; on a headless host the
equivalent surface is offline: numpy image composition for the frame
overlay and matplotlib (Agg) for the map view, written to PNG/MP4 by a
lazily imported imageio."""

from .frame_drawer import FrameDrawer  # noqa: F401
from .map_drawer import MapDrawer  # noqa: F401
from .viewer import Viewer  # noqa: F401
