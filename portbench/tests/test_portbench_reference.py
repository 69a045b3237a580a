"""The benchmark's plain decoder gives the format's decoders' bits: the
port's and the native CPU decoder's, on every kind of frame the cells make
(pure base, residual, chunk-masked planes, zstd'd base, constant,
pointwise)."""

import numpy as np
import pytest
import torch

from portbench_small import ROOT  # noqa: F401

import ebcc_tpu_torch as et
from ebcc_tpu_torch.codec.config import EBCCConfig, ResidualMode
from portbench.reference import decode


def _frames():
    g = np.random.default_rng(0)
    h, w = 72, 136
    yy, xx = np.meshgrid(np.linspace(0, 3, h), np.linspace(0, 6, w),
                         indexing="ij")
    base = (np.sin(yy) * np.cos(xx) * 100 + 5000).astype(np.float32)
    data = np.stack([base + g.normal(0, s, (h, w)).astype(np.float32)
                     for s in (0.5, 2.0, 5.0, 0.0)])
    data[3] = 7.0
    return data


CASES = {
    "maxerr": (EBCCConfig(mode=ResidualMode.MAX_ERROR, error=1.0,
                          base_cr=30), {}),
    "maxerr_q": (EBCCConfig(mode=ResidualMode.MAX_ERROR, error=0.5,
                            base_cr=100), {"qbase": 1e-2}),
    "pointwise": (EBCCConfig(mode=ResidualMode.POINTWISE_MAX_ERROR,
                             base_cr=100),
                  {"error_bound": np.full((4, 72, 136), 0.7, np.float32)}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bits_of_the_format_decoders(case):
    cfg, kw = CASES[case]
    data = _frames()
    blob = et.compress(data, cfg, device="cpu", **kw)
    native = et.decompress(blob, EBCCConfig(decode_backend="cpu"))
    port = et.decompress(blob, EBCCConfig(decode_backend="device"),
                         device="cpu")
    mine = np.stack([decode.decode_frame(f).numpy()
                     for f in decode.split_blob(blob)])
    assert np.array_equal(mine, native)
    assert np.array_equal(mine, port)
    flags = [decode.parse_frame(f)["flags"] for f in decode.split_blob(blob)]
    assert flags[3] & decode.FLAG_CONST


def test_covers_masks_residuals_and_zstd():
    cfg, kw = CASES["maxerr_q"]
    frames = [decode.parse_frame(f) for f in
              decode.split_blob(et.compress(_frames(), cfg, device="cpu",
                                            **kw))]
    assert any(f["base_mask"][0] != decode.MASK_NONE for f in frames)
    assert any(f["resid"] and f["resid"]["mask"][0] != decode.MASK_NONE
               for f in frames)
    assert any(f["flags"] & decode.FLAG_BASE_Z for f in frames)


def test_weights_are_the_formats():
    from ebcc_tpu_torch.ops import weights
    for levels in (1, 3, 5):
        assert np.array_equal(decode.subband_weights(levels),
                              weights.subband_weights(levels))


def test_corrupt_containers_raise():
    blob = et.compress(_frames()[:1], CASES["maxerr"][0], device="cpu")
    with pytest.raises(decode.CorruptFrame):
        decode.split_blob(blob[:-3])
    frame = decode.split_blob(blob)[0]
    with pytest.raises(decode.CorruptFrame):
        decode.parse_frame(b"XXXX" + frame[4:])
    assert torch.isfinite(decode.decode_frame(frame)).all()
