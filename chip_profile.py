"""Frame times and device idle share of the port's System on one card.

    python3 chip_profile.py [--out profile.json] [--runs system,kb8]

Runs ``System.track_monocular``, ``track_stereo`` and ``track_rgbd``
from a cold map over the 30 rendered 640x480 frames of ``chip_smoke.py``
([system], [stereo], [rgbd]), ``track_monocular(img, ts, imu=...)`` over
[vi]'s 40 frames of the visual-inertial scene and ``track_stereo(l, r, ts,
imu=...)`` over [vi-stereo]'s 40 frames of it seen by the rig, and
``track_monocular`` through the KB8 fisheye over [kb8]'s 30 512x512
frames (1500 features), ``track_stereo`` on the fisheye rig over
[stereo-kb8]'s 30 frames, and [vi]'s trajectory through KB8 on the rig
([vi-stereo-kb8], imu-stereo) and monocular ([vi-kb8]), each twice:
first all nine unprofiled
(host clock per frame, each frame ending in a synchronise), then each
under ``torch.profiler``, with every frame inside a ``record_function``
range.  (A trace's hundreds of thousands of events slow the host's
garbage collector, so no unprofiled run follows a profiled one.)
A frame's device time is the union of the device events (kernels and
copies) that start inside its range; a frame ends in a synchronise, so no
device work crosses into the next.  The idle share of a frame is 1 -
device time / the unprofiled host time of the same frame.  The inertial
runs' frames are split into pre-init frames, fused inertial frames, the
other post-init frames (the legacy inertial solve: every post-init frame
of [vi-stereo]), keyframe events, and the event on which the IMU
initialisation fired.
Then the three visual sensors again at ``tracking.pipeline_depth`` 0 and
3 (the mono run through [pipelined]'s FR1-distorted camera and frames),
without a synchronise after each frame, since a pipelined frame returns
while its step still runs: the median host time of an ordinary track call,
the time per frame over the span from frame 5 to the end of the flush,
and the idle share of that span, 1 - the union of its device events (a
profiled run) / the unprofiled span's host time.
Then [pipelined-vi]: [vi] at depth 3, the fused inertial frames' track
call host ms without a synchronise a frame and their device ms from a
profiled run that synchronises after each frame.
Last, the loop event of [loop] and [loop-kb8] and the merge frame of
[merge] and [merge-kb8] (``chip_smoke.py``'s constructed loop and merge
sweep, pinhole and through TUM-VI's KB8 camera): host ms unprofiled,
device ms profiled, idle share.
Prints one summary line per run and, with ``--out``, writes the per-frame
times and the largest kernels there as JSON.  ``--runs`` names the sensor
runs to make (default all nine, then the pipelined and event runs; with
the option only those, both ways, and ``pipelined-vi`` among them the
[pipelined-vi] run: a short comparison of two trees in one call).  Needs a card; fails without one.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
import port_fixtures as pf  # noqa: E402
from extractorb_tpu_torch.slam.system import System  # noqa: E402


def track_all(cfg, frames, second, dev, mark=None, sync=True, span_from=None):
    """One cold-map run; per frame (host ms, keyframe event, fused inertial
    frame, the IMU initialised on this frame).  ``sync=False`` leaves out
    the synchronise around each frame; with ``span_from`` the last element
    is the host ms from that frame's start to the end of the flush."""
    sys_ = System(cfg, device=dev)
    tr = sys_.tracker
    out = []
    for k, img in enumerate(frames):
        n_kf, n_fused = sys_.n_keyframes(), tr.n_fused_frames
        inited = tr.atlas.current.imu_initialized
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if k == span_from:
            t_span = t0
        with (torch.profiler.record_function(f"frame_{k}") if mark
              else contextlib.nullcontext()):
            if cfg.sensor == "stereo":
                sys_.track_stereo(img, second[k], k / 30.0)
            elif cfg.sensor == "rgbd":
                sys_.track_rgbd(img, second[k], k / 30.0)
            elif cfg.sensor in ("imu-monocular", "imu-stereo"):
                ts = k / pf.VI_FPS
                imu = pf.imu_window((k - 1) / pf.VI_FPS, ts) if k else None
                if second is None:
                    sys_.track_monocular(img, ts, imu=imu)
                else:
                    sys_.track_stereo(img, second[k], ts, imu=imu)
            else:
                sys_.track_monocular(img, k / 30.0)
            if sync:
                torch.cuda.synchronize()
        out.append(((time.perf_counter() - t0) * 1e3, sys_.n_keyframes() != n_kf,
                    tr.n_fused_frames != n_fused,
                    tr.atlas.current.imu_initialized and not inited))
    sys_.flush()
    torch.cuda.synchronize()
    if span_from is not None:
        out.append((time.perf_counter() - t_span) * 1e3)
    return out


def span_device_ms(prof, first: int) -> float:
    """Union of the device events that start at or after frame ``first``'s
    range begins (to the end of the run), in ms."""
    start = next(e.time_range.start for e in prof.events() if e.name == f"frame_{first}"
                 and e.device_type == torch.autograd.DeviceType.CPU)
    ev = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.startswith("frame_") and e.time_range.start >= start)
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in ev:
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


# the pipelined comparison's span starts at frame 5: after the initialisation
# and the step graph's eager warm-up calls and capture (frame 3 or 4)
SPAN_FROM = 5


def pipeline_runs(frames, rights, depths, dev) -> dict:
    """The three visual sensors at depth 0 and depth 3, without a
    synchronise a frame: ordinary-call host ms, span ms per frame, idle."""
    fr1, _ = cs.fr1_frames()
    out = {}
    for name, base, fr, second in (("system", cs.fr1_config(0), fr1, None),
                                   ("stereo", cs.stereo_config("stereo"), frames, rights),
                                   ("rgbd", cs.stereo_config("rgbd"), frames, depths)):
        for depth in (0, cs.PIPE_DEPTH):
            cfg = dataclasses.replace(base, tracking=dataclasses.replace(
                base.tracking, pipeline_depth=depth))
            plain = track_all(cfg, fr, second, dev, sync=False, span_from=SPAN_FROM)
            span_ms = plain.pop()
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                track_all(cfg, fr, second, dev, mark=True, sync=False, span_from=SPAN_FROM)
            busy = span_device_ms(prof, SPAN_FROM)
            del prof
            host = [h for h, *_ in plain]
            ordinary = [host[k] for k in range(SPAN_FROM, len(host)) if not plain[k][1]]
            n = len(host) - SPAN_FROM
            r = dict(host_ms_ordinary_call=statistics.median(ordinary), span_ms=span_ms,
                     span_ms_per_frame=span_ms / n, span_device_ms=busy,
                     span_idle=1.0 - busy / span_ms, n_span_frames=n, host_ms=host)
            out[f"{name}-depth{depth}"] = r
            print(f"[{name} depth {depth}] ordinary track call: host "
                  f"{r['host_ms_ordinary_call']:.2f} ms (median); frames {SPAN_FROM}-{len(host) - 1} with the flush: "
                  f"{span_ms:.1f} ms, {r['span_ms_per_frame']:.2f} ms per frame, device "
                  f"{busy:.1f} ms, idle {r['span_idle']:.4f}", flush=True)
    return out


def pipelined_vi_run(frames, dev) -> dict:
    """[pipelined-vi]: [vi]'s 40 frames at depth 3.  The fused inertial
    frames' track-call host ms from a run without a synchronise a frame
    (a pipelined call returns while its step runs), and their device ms
    from a profiled run that synchronises after each frame (so each
    frame's device work starts inside its range)."""
    cfg = dataclasses.replace(cs.vi_config(), tracking=dataclasses.replace(
        cs.vi_config().tracking, pipeline_depth=cs.PIPE_DEPTH))
    plain = track_all(cfg, frames, None, dev, sync=False)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        synced = track_all(cfg, frames, None, dev, mark=True)
    device, _, n_ev = device_ms_per_frame(prof, len(frames))
    del prof
    fused = [k for k, (_, kf, f, _) in enumerate(plain) if f and not kf]
    fused_s = [k for k, (_, kf, f, _) in enumerate(synced) if f and not kf]
    med = lambda v: statistics.median(v) if v else float("nan")
    r = dict(host_ms_fused_call=med([plain[k][0] for k in fused]),
             device_ms_fused=med([device[k] for k in fused_s]),
             host_ms_fused_synced=med([synced[k][0] for k in fused_s]), n_fused=len(fused),
             n_fused_synced=len(fused_s), host_ms=[h for h, *_ in plain], device_ms=device,
             n_device_events=n_ev)
    print(f"[pipelined-vi depth {cs.PIPE_DEPTH}] fused inertial frames: track call host "
          f"{r['host_ms_fused_call']:.2f} ms (median, {len(fused)} frames, no synchronise); "
          f"device {r['device_ms_fused']:.3f} ms, host {r['host_ms_fused_synced']:.2f} ms "
          f"with a synchronise a frame ({len(fused_s)} frames)", flush=True)
    return r


def merge_track(cfg, frames, voc, dev, mark=None):
    """[merge]'s run (frames 19-28 black) with a vocabulary: per frame the
    host ms (each frame ending in a synchronise) and the Atlas merges so far."""
    sys_ = System(cfg, vocab=voc, device=dev)
    out = []
    for k, img in enumerate(pf.blackout(frames, cs.MERGE_BLACK)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (torch.profiler.record_function(f"frame_{k}") if mark
              else contextlib.nullcontext()):
            sys_.track_monocular(img, k / 30.0)
            torch.cuda.synchronize()
        out.append(((time.perf_counter() - t0) * 1e3, sys_.tracker.loop_closer.n_merges))
    sys_.flush()
    torch.cuda.synchronize()
    return out


def event_runs(dev) -> dict:
    """The loop event of [loop] and [loop-kb8] (``cs.run_loop``: the closer
    over the constructed map to its first loop; the event dispatches the
    GBA, which runs before its closing synchronise) and the merge frame of
    [merge] and [merge-kb8]: host ms unprofiled, device ms (union of the
    event's device events) profiled, and the idle share; beside them the
    median of the other keyframe events (loop) or tracked frames (merge),
    and the run's largest kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {}
    for kb8 in (False, True):
        name = "loop-kb8" if kb8 else "loop"
        _, _, loops, host, _, _ = cs.run_loop(dev, kb8=kb8)
        with torch.profiler.profile(activities=acts) as prof:
            _, _, loops_p, _, _, _ = cs.run_loop(dev, kb8=kb8, mark=True)
        device, by_kernel, _ = device_ms_per_frame(prof, len(host))
        del prof
        if len(loops) != 1 or loops != loops_p:
            raise AssertionError(f"[{name}] loops {loops} / profiled {loops_p}")
        k = len(host) - 1
        rest = list(range(k))
        out[name] = _event(host, device, k, rest, by_kernel)
    for kb8 in (False, True):
        name = "merge-kb8" if kb8 else "merge"
        frames, _ = cs.merge_frames(kb8)
        voc = cs.train_vocab(frames, dev, n_features=cs.KB8_FEATURES if kb8 else cs.SYS_FEATURES)
        cfg = cs.merge_config(cs.KB8_SIZE, cs.KB8_SIZE, kb8=True) if kb8 else cs.merge_config()
        plain = merge_track(cfg, frames, voc, dev)
        with torch.profiler.profile(activities=acts) as prof:
            prof_run = merge_track(cfg, frames, voc, dev, mark=True)
        device, by_kernel, _ = device_ms_per_frame(prof, len(plain))
        del prof
        at = next((k for k, (_, n) in enumerate(plain) if n), None)
        if at is None or at != next((k for k, (_, n) in enumerate(prof_run) if n), None):
            raise AssertionError(f"[{name}] merge frame {at} / profiled run's differs")
        rest = [k for k in range(2, len(plain)) if k != at and k not in cs.MERGE_BLACK]
        out[name] = _event([h for h, _ in plain], device, at, rest, by_kernel)
    for name, r in out.items():
        print(f"[{name}] the {'merge frame' if 'merge' in name else 'loop event'} "
              f"({r['index']}): host {r['host_ms']:.2f} ms, device {r['device_ms']:.3f} ms, "
              f"idle {r['idle']:.4f}; the others' median: host {r['host_ms_others']:.2f} ms, "
              f"device {r['device_ms_others']:.3f} ms; the run's largest kernels "
              f"{', '.join(f'{n} {v:.3f}' for n, v in list(r['top_kernels_ms'].items())[:4])} ms",
              flush=True)
    return out


def _event(host, device, k, rest, by_kernel) -> dict:
    return dict(index=k, host_ms=host[k], device_ms=device[k], idle=1.0 - device[k] / host[k],
                host_ms_others=statistics.median([host[j] for j in rest]),
                device_ms_others=statistics.median([device[j] for j in rest]),
                host_ms_all=host, device_ms_all=device,
                top_kernels_ms=dict(sorted(((n, v / 1e3) for n, v in by_kernel.items()),
                                           key=lambda kv: -kv[1])[:10]))


def device_ms_per_frame(prof, n_frames: int):
    """Union of device-event time inside each frame's range, in ms."""
    frames, dev_events = {}, []
    for e in prof.events():
        if e.name.startswith("frame_"):
            # the range also appears on the device timeline as an annotation
            if e.device_type == torch.autograd.DeviceType.CPU:
                frames[int(e.name[6:])] = (e.time_range.start, e.time_range.end)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev_events.append((e.time_range.start, e.time_range.end, e.name))
    dev_events.sort()
    out, by_kernel = [], {}
    for k in range(n_frames):
        a, b = frames[k]
        busy, cur_s, cur_e = 0.0, None, None
        for s, e, name in dev_events:
            if s < a or s >= b:
                continue
            by_kernel[name] = by_kernel.get(name, 0.0) + (e - s)
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        out.append(busy / 1e3)
    return out, by_kernel, len(dev_events)


def summarise_vi(host, info, device):
    """An inertial run: pre-init frames (after the first two), fused
    inertial frames, the other post-init frames (legacy inertial solve) and
    keyframe events apart, the init-stage event alone."""
    init = next((k for k, (_, _, _, i) in enumerate(info) if i), None)
    inited = [init is not None and k >= init for k in range(len(host))]
    groups = {
        "pre_init": [k for k in range(2, len(host)) if not inited[k] and not info[k][1]],
        "fused": [k for k in range(len(host)) if info[k][2] and not info[k][1]],
        "legacy": [k for k in range(len(host)) if inited[k] and k != init and not info[k][2]
                   and not info[k][1]],
        "keyframe": [k for k in range(1, len(host)) if info[k][1] and k != init],
    }
    out = {"init_frame": init}
    for g, ks in groups.items():
        out[f"host_ms_{g}"] = statistics.median([host[k] for k in ks]) if ks else float("nan")
        out[f"device_ms_{g}"] = statistics.median([device[k] for k in ks]) if ks else float("nan")
        out[f"idle_{g}"] = (1.0 - sum(device[k] for k in ks) / sum(host[k] for k in ks)
                            if ks else float("nan"))
        out[f"n_{g}"] = len(ks)
    if init is not None:
        out.update(host_ms_init=host[init], device_ms_init=device[init],
                   idle_init=1.0 - device[init] / host[init])
    return out


def summarise(host, kf, device):
    """Medians and idle shares of ordinary frames (after the first two:
    initialisation and the host-path frame) and of keyframe events."""
    ordinary = [k for k in range(len(host)) if k > 1 and not kf[k]]
    events = [k for k in range(len(host)) if k > 0 and kf[k]]
    med = lambda ks, a: statistics.median([a[k] for k in ks]) if ks else float("nan")
    idle = lambda ks: 1.0 - sum(device[k] for k in ks) / sum(host[k] for k in ks) if ks \
        else float("nan")
    return dict(host_ms_ordinary=med(ordinary, host), host_ms_keyframe=med(events, host),
                device_ms_ordinary=med(ordinary, device), device_ms_keyframe=med(events, device),
                idle_ordinary=idle(ordinary), idle_keyframe=idle(events),
                n_ordinary=len(ordinary), n_keyframe_events=len(events))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="JSON file for the per-frame times and kernel sums")
    ap.add_argument("--runs", help="comma-separated sensor runs (e.g. system,kb8); only those")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_profile.py runs on a card only")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    frames, rights, depths, _ = pf.render_stereo_sequence(
        pf.procedural_texture(), cs.SYS_FRAMES, cs.SYS_SPEED, cs.WIDTH, cs.HEIGHT,
        cs.STEREO_BASELINE)
    vi_frames, _ = cs.vi_frames()
    vi_left, vi_right = cs.vi_stereo_frames()
    kb8_frames, _ = cs.kb8_frames()
    rig_l, rig_r, _ = cs.rig_frames()
    vk_l, vk_r, _ = cs.vi_rig_frames()
    runs = {"system": (cs.system_config(), frames, None),
            "kb8": (cs.kb8_config(), kb8_frames, None),
            "stereo": (cs.stereo_config("stereo"), frames, rights),
            "rgbd": (cs.stereo_config("rgbd"), frames, depths),
            "vi": (cs.vi_config(), vi_frames, None),
            "vi-stereo": (cs.vi_stereo_config(), vi_left, vi_right),
            "stereo-kb8": (cs.kb8_rig_config(), rig_l, rig_r),
            "vi-stereo-kb8": (cs.kb8_rig_config("imu-stereo"), vk_l, vk_r),
            "vi-kb8": (cs.vi_kb8_config(), vk_l, None)}
    extra = ("pipelined-vi",)   # not a sensor run: made after them
    if args.runs:
        unknown = set(args.runs.split(",")) - set(runs) - set(extra)
        if unknown:
            raise ValueError(f"chip_profile.py: no run {sorted(unknown)}; the runs: {list(runs)}")
        runs = {k: v for k, v in runs.items() if k in args.runs.split(",")}
    result = dict(card=smi, frames=cs.SYS_FRAMES, vi_frames=cs.VI_FRAMES,
                  vi_stereo_frames=len(vi_left))
    track_all(cs.system_config(), frames[:3], None, dev)   # warm-up: build and first launches
    plain = {name: track_all(cfg, fr, second, dev) for name, (cfg, fr, second) in runs.items()}
    for name, (cfg, fr, second) in runs.items():
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            track_all(cfg, fr, second, dev, mark=True)
        device, by_kernel, n_ev = device_ms_per_frame(prof, len(fr))
        host = [h for h, *_ in plain[name]]
        kf = [e[1] for e in plain[name]]
        s = summarise_vi(host, plain[name], device) if name.startswith("vi") \
            else summarise(host, kf, device)
        s.update(host_ms=host, device_ms=device, keyframe=kf, n_device_events=n_ev,
                 top_kernels_ms=dict(sorted(((k, v / 1e3) for k, v in by_kernel.items()),
                                            key=lambda kv: -kv[1])[:15]))
        result[name] = s
        if name.startswith("vi"):
            print(f"[{name}] " + "; ".join(
                f"{g}: host {s[f'host_ms_{g}']:.2f} ms, device {s[f'device_ms_{g}']:.3f} ms, "
                f"idle {s[f'idle_{g}']:.4f} ({s[f'n_{g}']} frames)"
                for g in ("pre_init", "fused", "legacy", "keyframe"))
                + (f"; the init event (frame {s['init_frame']}): host {s['host_ms_init']:.2f} ms, "
                   f"device {s['device_ms_init']:.3f} ms, idle {s['idle_init']:.4f}"
                   if s["init_frame"] is not None else "") + f" ({n_ev} device events)",
                flush=True)
        else:
            print(f"[{name}] ordinary frames: host {s['host_ms_ordinary']:.2f} ms, device "
                  f"{s['device_ms_ordinary']:.3f} ms, idle {s['idle_ordinary']:.4f}; keyframe "
                  f"events: host {s['host_ms_keyframe']:.2f} ms, device "
                  f"{s['device_ms_keyframe']:.3f} ms, idle {s['idle_keyframe']:.4f} "
                  f"({n_ev} device events)", flush=True)
        del prof
    if not args.runs:
        result["pipelined"] = pipeline_runs(frames, rights, depths, dev)
    if not args.runs or "pipelined-vi" in args.runs.split(","):
        result["pipelined-vi"] = pipelined_vi_run(vi_frames, dev)
    if not args.runs:
        result["events"] = event_runs(dev)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
