"""Per-stage timing instrumentation (port of ``extractorb_tpu/utils/timing.py``).

Replaces the reference's SAVE_TIMES chrono hooks (inc/Frame.h:23,
src/Tracking.cc:1097-1105 CSV, src/LocalMapping.cc t0-t8 timers) with a
lightweight stage profiler using the reference's stage taxonomy:
extract, stereo-match, imu-preint, pose-predict, match, pose-opt,
local-map-track, kf-decision, lm-triangulate, lm-ba, pr, pgo, gba.  Each
stage is a ``torch.profiler.record_function`` range, so it shows in a
profiler trace.  The host clock measures what the stage enqueues: on the
card, synchronise inside the stage to time its device work.
"""

from __future__ import annotations

import contextlib
import csv
import time
from collections import defaultdict
from typing import Dict, List

import torch


class StageTimer:
    def __init__(self):
        self.samples: Dict[str, List[float]] = defaultdict(list)
        self.enabled = True

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, xs in self.samples.items():
            arr = sorted(xs)
            n = len(arr)
            out[name] = {
                "count": n,
                "mean_ms": 1e3 * sum(arr) / n,
                "p50_ms": 1e3 * arr[n // 2],
                "p95_ms": 1e3 * arr[min(n - 1, int(0.95 * n))],
                "total_s": sum(arr),
            }
        return out

    def write_csv(self, path: str):
        """f_track_times-style CSV (reference Tracking.cc:1097)."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["stage", "count", "mean_ms", "p50_ms", "p95_ms", "total_s"])
            for name, s in sorted(self.summary().items()):
                w.writerow(
                    [name, s["count"], f"{s['mean_ms']:.3f}",
                     f"{s['p50_ms']:.3f}", f"{s['p95_ms']:.3f}",
                     f"{s['total_s']:.3f}"]
                )


GLOBAL_TIMER = StageTimer()
