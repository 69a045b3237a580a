"""Each generator is deterministic from its seed, keeps the published
721 x 1440 grid, and the spread's upsampling is the reference scheme."""

import numpy as np
import pytest

from portbench_small import ROOT

from portbench import core, fields
from ebcc_tpu_torch import dataprep

CONFIGS = ("era5_z500_maxerr", "era5_t2m_pointwise")


def _config(name):
    return core._json(f"{ROOT}/portbench/configs/{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
def test_deterministic_from_the_seed(name):
    cfg = dict(_config(name), pool_frames=3)
    a = core.make_inputs(cfg)
    b = core.make_inputs(cfg)
    c = core.make_inputs(dict(cfg, field_seed=cfg["field_seed"] + 1))
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["frames"], c["frames"])


@pytest.mark.parametrize("name", CONFIGS)
def test_published_grid(name):
    cfg = dict(_config(name), pool_frames=4)
    assert (cfg["h"], cfg["w"], cfg["dtype"]) == (721, 1440, "float32")
    out = core.make_inputs(cfg)
    for a in out.values():
        assert a.shape == (4, 721, 1440) and a.dtype == np.float32
        assert np.isfinite(a).all()
    if "bound" in out:
        assert (out["bound"] > 0).all()
    # hourly frames are correlated: an hour's change is small beside the
    # field's own spread
    x = out["frames"]
    assert np.diff(x, axis=0).std() < 0.1 * x.std()


def test_upsampling_is_the_reference_scheme():
    a = np.random.default_rng(0).random((5, 9, 16)).astype(np.float32)
    assert np.array_equal(fields.upsample_3t_2s(a),
                          dataprep.upsample_3t_2s(a))
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(3) as pool:
        assert np.array_equal(fields.upsample_3t_2s_chunked(a, pool, 2),
                              dataprep.upsample_3t_2s(a))
