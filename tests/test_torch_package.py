"""Packaging rules of the PyTorch port.

``extractorb_tpu_torch`` must import without jax, cv2, triton, PyYAML, the
JAX package or a CUDA toolkit, build nothing at import time, and its
card-only tests must skip cleanly on a machine without a card.
"""

import ast
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import extractorb_tpu_torch
from extractorb_tpu_torch import kernels
from torch_card import cuda_device  # noqa: F401  (pytest fixture)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "extractorb_tpu_torch"
MODULES = sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "extractorb_tpu_torch."))

_BLOCKED_IMPORT = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "cv2", "triton", "yaml", "extractorb_tpu"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
import importlib
for m in sys.argv[1:]:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "cv2", "triton", "yaml", "extractorb_tpu"))
assert not bad, bad
print("ok", len(sys.argv) - 1)
"""


def test_every_module_imports_without_jax_cv2_triton_or_nvcc(tmp_path):
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path), PYTHONPATH=str(ROOT))
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT, *MODULES],
                         capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"ok {len(MODULES)}"
    assert len(MODULES) >= 20
    for m in ("geometry.two_view", "solver.ba", "slam.map", "slam.local_mapping",
              "slam.tracking", "slam.system", "utils.packed_fetch", "frontend.stereo",
              "solver.pnp", "slam.checkpoint", "imu.calib", "imu.preintegration",
              "solver.inertial", "solver.marginal", "slam.imu_frontend", "utils.clahe",
              "frontend.grid", "viz.frame_drawer", "demos.demo_frame", "dist.mesh",
              "dist.kf_blocks", "dist.sharded_pose_graph"):
        assert f"extractorb_tpu_torch.{m}" in MODULES, m


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_source_has_no_forbidden_import(path):
    src = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax|jaxlib|cv2|extractorb_tpu)\b(?!_torch)",
                     src, flags=re.M)
    assert not bad, bad
    # triton and the kernel build are imported or run lazily only
    assert not re.search(r"^(?:import|from)\s+triton", src, flags=re.M)


def _string_constants(tree: ast.AST):
    """The string constants of a module other than its docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            first = node.body[0] if node.body else None
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                docs.add(id(first.value))
    return [n for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs]


def test_source_names_no_path_into_the_jax_package():
    """No string of the port's code names a path into ``extractorb_tpu/``
    (a path component ``extractorb_tpu``, not ``extractorb_tpu_torch``):
    the port reads nothing of the JAX package, not even a data file."""
    component = re.compile(r"(?:^|[/\\])extractorb_tpu(?:$|[/\\])")
    bad = [f"{p.relative_to(ROOT)}:{n.lineno}: {n.value!r}"
           for p in sorted(PKG.rglob("*.py"))
           for n in _string_constants(ast.parse(p.read_text()))
           if component.search(n.value)]
    assert not bad, bad
    # the rule catches the form the BRIEF pattern's path once had
    old = ast.parse('P = Path(__file__).parents[2] / "extractorb_tpu" / "data" / "x.npy"')
    assert any(component.search(n.value) for n in _string_constants(old))


def test_orb_pattern_is_the_port_copy():
    """The BRIEF pattern is read from the port's own file, which holds the
    JAX package's bytes."""
    from extractorb_tpu_torch.frontend import brief

    own = PKG / "data" / "orb_pattern.npy"
    assert brief.PATTERN_FILE == own
    assert own.read_bytes() == (ROOT / "extractorb_tpu" / "data" / "orb_pattern.npy").read_bytes()
    pat = brief._pattern()[0]
    assert pat.shape == (256, 4) and pat.dtype == np.int8


_TUM1_YAML = """%YAML:1.0
Camera.type: "PinHole"
Camera.fx: 517.306408
Camera.fy: 516.469215
Camera.cx: 318.643040
Camera.cy: 255.313989
Camera.k1: 0.262383
Camera.k2: -0.953104
Camera.p1: -0.005358
Camera.p2: 0.002628
Camera.k3: 1.163314
Camera.width: 640
Camera.height: 480
Camera.fps: 30.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def test_config_is_the_reference_copy(tmp_path):
    """The port's config module is the JAX package's, field for field."""
    import dataclasses

    from extractorb_tpu import config as jconfig
    from extractorb_tpu_torch import config

    for name in ("ORBConfig", "CameraConfig", "IMUConfig", "TrackingConfig", "SLAMConfig"):
        assert (dataclasses.asdict(getattr(config, name)())
                == dataclasses.asdict(getattr(jconfig, name)())), name
    path = tmp_path / "TUM1.yaml"
    path.write_text(_TUM1_YAML)
    got, want = config.load_yaml(str(path)), jconfig.load_yaml(str(path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.camera.k1 == 0.262383 and got.orb.n_features == 1000
    assert got.orb.features_per_level == want.orb.features_per_level


def test_no_build_without_nvcc(monkeypatch, tmp_path):
    """Without a toolkit the build raises; it never falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()
    assert kernels._lib is None  # importing the package built and loaded nothing
    assert kernels.library_path().name.startswith("libextractorb_kernels_")


def test_card_only_tests_skip_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the card-only tests run instead")
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--noconftest",
         "-m", "gpu", "-rs", str(ROOT / "tests" / "test_torch_package.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "1 skipped" in res.stdout and "needs a CUDA card" in res.stdout, res.stdout


def _vi_system(sensor: str, vocab: bool):
    import dataclasses

    import numpy as np

    import chip_smoke
    from extractorb_tpu_torch.place.vocab import Vocabulary
    from extractorb_tpu_torch.slam.system import System

    cfg = dataclasses.replace(chip_smoke.vi_config(320, 240, 500), sensor=sensor)
    voc = None
    if vocab:
        rng = np.random.default_rng(0)
        voc = Vocabulary.train(rng.integers(0, 256, (200, 32), dtype=np.uint8), k=4, L=2)
    return lambda: System(cfg, vocab=voc, device="cpu")


def test_unported_inertial_configurations_raise():
    """imu-rgbd raises: the JAX package's track_rgbd takes no IMU
    measurements, so there is no such entry point to port."""
    with pytest.raises(NotImplementedError, match="no such entry point"):
        _vi_system("imu-rgbd", False)()


@pytest.mark.parametrize("sensor,vocab", [("imu-stereo", False), ("imu-monocular", True)],
                         ids=["imu-stereo", "imu-with-vocabulary"])
def test_inertial_configurations_are_ported(sensor, vocab):
    """imu-stereo and an inertial sensor with a vocabulary (its loop closer
    takes the tracker's IMU calibration) are ported."""
    tr = _vi_system(sensor, vocab)().tracker
    assert tr.inertial and tr.loop_closer.imu_calib is tr.imu_calib is not None
    assert (tr.loop_closer.db is not None) == vocab


def test_inertial_system_without_device_needs_a_card(monkeypatch):
    import chip_smoke
    from extractorb_tpu_torch.slam.system import System

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        System(chip_smoke.vi_config(320, 240, 500))


@pytest.mark.gpu
def test_kernel_library_builds_and_counts_launches(cuda_device):
    from extractorb_tpu_torch.frontend import matcher

    lib = kernels.lib()
    for name in kernels._SIGNATURES:
        assert getattr(lib, name).restype is not None
    before = kernels.LAUNCHES["hamming_best2"]
    d = torch.randint(0, 256, (64, 32), dtype=torch.uint8, device=cuda_device)
    ok = torch.ones(64, dtype=torch.bool, device=cuda_device)
    r = matcher.hamming_best2(d, ok, d, ok)
    assert kernels.LAUNCHES["hamming_best2"] == before + 1
    assert torch.equal(r.best_idx.cpu(), torch.arange(64, dtype=torch.int32))
    assert extractorb_tpu_torch.__version__


DEMOS = ("demo_clahe", "demo_clahe_keypoint", "demo_orb_extractor", "demo_distribute_oct_tree",
         "demo_whole_extractor", "demo_frame", "demo_matcher")


def _entry_points():
    import functools
    import importlib

    from extractorb_tpu_torch.dist import global_ba
    from extractorb_tpu_torch.dist import mesh
    from extractorb_tpu_torch.place.database import KeyFrameDatabase
    from extractorb_tpu_torch.slam import imu_frontend as front
    from extractorb_tpu_torch.slam import merge
    from extractorb_tpu_torch.slam.loop_closing import LoopCloser

    return {
        "LoopCloser": lambda: LoopCloser(None, None),
        "KeyFrameDatabase": lambda: KeyFrameDatabase(None),
        "build_global_problem": lambda: global_ba.build_global_problem(None, [1.0], 1),
        "dispatch_global_ba": lambda: global_ba.dispatch_global_ba(None, None, [1.0], None),
        "make_mesh": lambda: mesh.make_mesh(),
        "ImuQueue": lambda: front.ImuQueue(None),
        "integrate_raw": lambda: front.integrate_raw(None, None, None),
        "integrate_raw_host": lambda: front.integrate_raw_host(None, None, None),
        "initialize_imu": lambda: front.initialize_imu(None, None),
        "full_inertial_ba": lambda: front.full_inertial_ba(None, None, None),
        "local_inertial_ba": lambda: front.local_inertial_ba(None, None, None, 0),
        "weld_inertial_bundle_adjustment":
            lambda: merge.weld_inertial_bundle_adjustment(None, None, None, 0),
        **{f"demos.{d}": functools.partial(
            importlib.import_module(f"extractorb_tpu_torch.demos.{d}").main, []) for d in DEMOS},
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_without_device_need_a_card(name, monkeypatch):
    """The port's entry points run on the card unless the caller passes
    device='cpu': without a card they raise before any work, never fall
    back to the plain path."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _entry_points()[name]()
