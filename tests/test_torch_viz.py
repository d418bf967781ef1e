"""ucnerf_torch.utils.viz against the JAX package's ``utils/viz.py``:
``visualize_depth`` bit for bit (the cases of ``tests/test_utils_obs.py``),
jet's lookup table against matplotlib's, and the validation panel's tiles
and padding against the JAX panel decoded with cv2 (the title strips,
drawn there by ``cv2.putText`` and blank here, are left out)."""

import cv2
import matplotlib
import numpy as np
import pytest
import torch

from ucnerf_tpu.utils import viz as j_viz

from ucnerf_torch.utils import viz
from ucnerf_torch.utils.png import read_png

torch.set_num_threads(1)

_rng = np.random.default_rng(0)
DEPTHS = {
    "ramp": np.linspace(0.5, 2.0, 12, dtype=np.float32).reshape(3, 4),
    "zero_pixel": np.array([[0.0, 1.0], [1.0, 2.0]], np.float32),
    "all_zero": np.zeros((2, 2), np.float32),
    "all_nan": np.full((2, 2), np.nan, np.float32),
    "nan_and_negative": np.array([[np.nan, -1.0, 0.5], [1.0, 3.0, 0.0]],
                                 np.float32),
    "unit_grid": np.linspace(0, 1, 4096, dtype=np.float32).reshape(64, 64),
    "random": _rng.uniform(0.5, 2.0, (33, 47)).astype(np.float32),
}


def test_jet_table_is_matplotlibs():
    cmap = matplotlib.colormaps["jet"]
    cmap._init()
    np.testing.assert_array_equal(viz.JET, cmap._lut[:viz.N_COLORS, :3])


@pytest.mark.parametrize("name", sorted(DEPTHS))
@pytest.mark.parametrize("minmax", [None, (0.0, 4.0)])
def test_visualize_depth_bitwise(name, minmax):
    got = viz.visualize_depth(DEPTHS[name], minmax)
    assert got.dtype == np.uint8 and got.shape == DEPTHS[name].shape + (3,)
    np.testing.assert_array_equal(got,
                                  j_viz.visualize_depth(DEPTHS[name], minmax))


def test_panel_tiles_and_padding_match_jax(tmp_path):
    H, W = 24, 40
    rng = np.random.default_rng(1)
    args = (rng.uniform(size=(H, W, 3)), rng.uniform(size=(H, W, 3)),
            rng.uniform(0.5, 2.0, size=(H, W)) * (rng.uniform(size=(H, W))
                                                  > 0.2),
            rng.uniform(0.5, 2.0, size=(H, W)))
    j_path, t_path = str(tmp_path / "j.png"), str(tmp_path / "sub" / "t.png")
    j_viz.save_val_panel(j_path, *args)
    viz.save_val_panel(t_path, *args)
    want = cv2.imread(j_path, cv2.IMREAD_COLOR)[..., ::-1]
    got = read_png(t_path)
    assert got.shape == want.shape == (2 * (viz.STRIP + H) + viz.PAD,
                                       2 * W + viz.PAD, 3)
    strips = np.zeros(got.shape[0], bool)
    for top in (0, viz.STRIP + H + viz.PAD):
        strips[top:top + viz.STRIP] = True
    np.testing.assert_array_equal(got[~strips], want[~strips])
    assert (got[strips] == 255).all()       # the strips are left blank
    np.testing.assert_array_equal(got[viz.STRIP + H + viz.PAD + viz.STRIP:,
                                      W + viz.PAD:],
                                  viz.visualize_depth(args[3]))
