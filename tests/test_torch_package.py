"""Packaging rules of the PyTorch port.

``extractorb_tpu_torch`` must import without jax, cv2, triton, PyYAML, the
JAX package or a CUDA toolkit, build nothing at import time, and its
card-only tests must skip cleanly on a machine without a card.
"""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

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
              "slam.tracking", "slam.system", "utils.packed_fetch"):
        assert f"extractorb_tpu_torch.{m}" in MODULES, m


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")))
def test_source_has_no_forbidden_import(path):
    src = (ROOT / path).read_text()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax|jaxlib|cv2|extractorb_tpu)\b(?!_torch)",
                     src, flags=re.M)
    assert not bad, bad
    # triton and the kernel build are imported or run lazily only
    assert not re.search(r"^(?:import|from)\s+triton", src, flags=re.M)


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
