"""The view-sharded cascade of ucnerf_torch (``--shard_mvs_views``) on 2
ranks (padded) and 3, against its replicated cascade and the JAX
package's ``make_view_sharded_cascade`` on a 2-device mesh."""

import numpy as np
import pytest
import torch

from ucnerf_torch.models.factory import create_models
from ucnerf_torch.render.serving import to_device_batch
from ucnerf_torch.train.loop import run_mvs

from test_torch_parallel import _spawn, jax_spec, parallel_case, run_both
from test_torch_train import ARGS

STAGE_FIELDS = ("depth", "photometric_confidence", "volume_feature",
                "depth_values", "prob_volume")


@pytest.fixture(scope="module")
def cascades():
    """The port's view-sharded cascade on the first 2 and on all 3 ranks
    of one rank set, its replicated cascade, and JAX's on 2 devices."""
    case = parallel_case()
    job = dict(kind="cascade", argv=ARGS, params=case["np_params"],
               sample=case["sample"])

    def port():
        return _spawn((3,), ("data",), [dict(job, ranks=2),
                                        dict(job, ranks=3)])

    got, refs = run_both(port, {"cascade": ("cascade", jax_spec(
        case, sample=case["sample"], n=2))})
    _, mvs = create_models(case["cfg"], "cpu", case["params"])
    with torch.no_grad():
        serial = run_mvs(case["cfg"], mvs,
                         to_device_batch(case["sample"], "cpu"))
    return dict(port={2: got[0], 3: got[1]}, jax=refs["cascade"],
                serial=serial)


@pytest.mark.parametrize("n", [2, 3])
def test_view_sharded_cascade_matches_jax(cascades, n):
    """The view-sharded cascade on 2 ranks (the 3 source views padded
    with a zero view) and on 3 (one view each): against the port's
    replicated cascade at the JAX package's own bound for its view split
    (every stage output within 1e-4 of its max, the features rtol 1e-4 /
    atol 1e-5, ``tests/test_parallel_views.py``), and against JAX's on a
    2-device mesh (which that test holds to JAX's replicated cascade) at
    the cascade's parity envelope
    (``tests/test_torch_mvs.py::test_cascade_matches_jax``)."""
    got, want = cascades["port"][n], cascades["jax"]
    serial = cascades["serial"]
    for k in ("stage1", "stage2", "stage3"):
        for f in STAGE_FIELDS:
            a, b = serial[k][f].numpy(), got[k][f]
            scale = max(np.abs(a).max(), 1e-8)
            assert np.abs(a - b).max() <= 1e-4 * scale, (n, k, f)
        o, r = got[k], want[k]
        np.testing.assert_allclose(o["depth"], r["depth"], rtol=5e-3,
                                   atol=2e-3, err_msg=f"{k} depth")
        assert np.abs(o["photometric_confidence"]
                      - r["photometric_confidence"]).mean() < 2e-3
        np.testing.assert_allclose(o["volume_feature"], r["volume_feature"],
                                   rtol=1e-2, atol=5e-3, err_msg=f"{k} vol")
        np.testing.assert_allclose(o["depth_values"], r["depth_values"],
                                   rtol=1e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(got["img_feats"],
                               serial["img_feats"].numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["img_feats"], want["img_feats"],
                               rtol=1e-4, atol=1e-4)
