"""The frame grid (``frontend/grid.py``): the port's plain versions against
the JAX ``pos_in_grid``, ``assign_features_to_grid`` and
``features_in_area_mask``, bit-equal, on the seeded edge cases of
``chip_smoke.py`` [parity-grid] (``port_fixtures.grid_cases``) and on a
512x512 extraction's keypoints; on the card kernel K28 (``csrc/grid.cu``)
against the plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_fixtures as pf
from extractorb_tpu.frontend import grid as jgrid
from extractorb_tpu_torch import kernels
from extractorb_tpu_torch.config import ORBConfig
from extractorb_tpu_torch.frontend import grid
from extractorb_tpu_torch.frontend.extractor import ORBExtractor
from torch_card import cuda_device, one_torch_thread  # noqa: F401  (pytest fixtures)

CASES = pf.grid_cases()


def extraction_case():
    """The keypoints of a 300-feature extraction of a 512x512 crop of the
    procedural texture (the port's plain extractor)."""
    img = torch.from_numpy(np.ascontiguousarray(pf.procedural_texture()[:512, :512]))
    f = ORBExtractor(ORBConfig(n_features=300, max_kps_per_level=1024), (512, 512), "cpu")(img)
    return (f.xy.numpy(), f.valid.numpy(), f.octave.numpy(),
            np.array([0.0, 512.0, 0.0, 512.0], np.float32), 16)


@pytest.fixture(scope="module")
def all_cases():
    return {**CASES, "extraction": extraction_case()}


def port(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def queries(bounds):
    """The level-gate queries of tests/test_grid.py, and one at the far
    corner of the bounds with a radius of 0 (an empty box)."""
    return pf.GRID_AREA_QUERIES + ((float(bounds[1]), float(bounds[3]), 0.0, 1, -1),)


@pytest.mark.parametrize("name", sorted(CASES) + ["extraction"])
def test_plain_matches_jax(name, all_cases):
    xy, valid, octave, bounds, cap = all_cases[name]
    txy, tvalid, toct, tb = port(xy, valid, octave, bounds)
    jxy, jvalid, joct, jb = (jnp.asarray(a) for a in (xy, valid, octave, bounds))
    for strict in (True, False):
        jc, jo = jgrid.pos_in_grid(jxy, jb, jvalid, 48, 64, strict)
        tc, to = grid.pos_in_grid_plain(txy, tb, tvalid, 48, 64, strict)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    jg, jn = jgrid.assign_features_to_grid(jxy, jb, jvalid, cell_capacity=cap)
    tg, tn = grid.assign_features_to_grid_plain(txy, tb, tvalid, cell_capacity=cap)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    for q in queries(bounds):
        want = np.asarray(jgrid.features_in_area_mask(jxy, joct, jvalid, *q))
        got = grid.features_in_area_mask_plain(txy, toct, tvalid, *q).numpy()
        np.testing.assert_array_equal(got, want, err_msg=str(q))


def test_capacity_keeps_the_first_and_counts_all():
    xy, valid, _, bounds, cap = CASES["one-cell-cap8"]
    g, counts = grid.assign_features_to_grid(*port(xy, bounds, valid), cell_capacity=cap)
    cx, cy = int(5.0 * 64 / 640), int(5.0 * 48 / 480)
    assert g[cy, cx].tolist() == list(range(8))
    assert int(counts[cy, cx]) >= 100
    assert int(counts.sum()) == int(grid.pos_in_grid(*port(xy, bounds, valid))[1].sum())


def test_wrappers_run_the_plain_versions_on_the_cpu():
    xy, valid, octave, bounds, cap = CASES["outside"]
    txy, tvalid, toct, tb = port(xy, valid, octave, bounds)
    before = dict(kernels.LAUNCHES)
    for a, b in zip(grid.pos_in_grid(txy, tb, tvalid), grid.pos_in_grid_plain(txy, tb, tvalid)):
        assert torch.equal(a, b)
    for a, b in zip(grid.assign_features_to_grid(txy, tb, tvalid),
                    grid.assign_features_to_grid_plain(txy, tb, tvalid)):
        assert torch.equal(a, b)
    assert torch.equal(grid.features_in_area_mask(txy, toct, tvalid, 320.0, 240.0, 50.0, 0, 3),
                       grid.features_in_area_mask_plain(txy, toct, tvalid, 320.0, 240.0, 50.0,
                                                        0, 3))
    assert dict(kernels.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CASES) + ["extraction"])
def test_kernel_matches_plain(name, cuda_device, all_cases):
    xy, valid, octave, bounds, cap = all_cases[name]
    txy, tvalid, toct, tb = port(xy, valid, octave, bounds)
    dxy, dvalid, doct, db = (a.to(cuda_device) for a in (txy, tvalid, toct, tb))
    before = dict(kernels.LAUNCHES)
    for strict in (True, False):
        for a, b in zip(grid.pos_in_grid(dxy, db, dvalid, strict=strict),
                        grid.pos_in_grid_plain(txy, tb, tvalid, strict=strict)):
            assert torch.equal(a.cpu(), b)
    for a, b in zip(grid.assign_features_to_grid(dxy, db, dvalid, cell_capacity=cap),
                    grid.assign_features_to_grid_plain(txy, tb, tvalid, cell_capacity=cap)):
        assert torch.equal(a.cpu(), b)
    for q in queries(bounds):
        assert torch.equal(grid.features_in_area_mask(dxy, doct, dvalid, *q).cpu(),
                           grid.features_in_area_mask_plain(txy, toct, tvalid, *q))
    torch.cuda.synchronize()
    n_q = len(queries(bounds))
    assert kernels.LAUNCHES["grid_pos"] == before.get("grid_pos", 0) + 2
    assert kernels.LAUNCHES["grid_assign"] == before.get("grid_assign", 0) + 1
    assert kernels.LAUNCHES["grid_area"] == before.get("grid_area", 0) + n_q
