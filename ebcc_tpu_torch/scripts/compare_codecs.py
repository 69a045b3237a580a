"""Cross-compressor acceptance table: EBCC against error-bounded and
lossless baselines at one bound.

    python -m ebcc_tpu_torch.scripts.compare_codecs [FRAME.npy]
        [--error 0.5] [--device cpu]

The port of ``scripts/compare_codecs.py`` (the reference's headline
evidence: data/compare.py:12-33, expected outputs data/logs.txt:1-29):
the same field at the same absolute max-error bound through EBCC
(MAX_ERROR, base_cr 100, on ``--device``) and through the baselines,
reimplemented from their published cores as the JAX script has them:

* ``quant-zstd``   — uniform scalar quantisation with step 2*eb + zstd
                     (SZ's zero-order/constant predictor mode)
* ``lorenzo-zstd`` — 2-D Lorenzo-predictor quantisation + zstd (SZ's
                     default first-order predictor core); a
                     row-sequential loop on the host, as SZ decodes
* ``zstd`` / ``zlib`` — lossless baselines (the reference sweep's
                     gzip/lzf analogues, hdf5_compression_sweep.py:87-94)

zstd is the ``zstandard`` package where it is installed, else the native
runtime's.  PASS when EBCC's compressed size beats both error-bounded
baselines; the exit code is 0 on PASS, 1 on FAIL.  The field is the
input, else the frame ``$EBCC_REFERENCE_FRAME`` names; without either
the run stops, as the JAX script does without its fixture.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import zlib

import numpy as np

from .. import api
from ..codec.config import EBCCConfig, ResidualMode
from ..runtime import native
from . import common


def zstd_pack(raw: bytes, level: int = 19) -> bytes:
    try:
        import zstandard
        return zstandard.ZstdCompressor(level=level).compress(raw)
    except ImportError:
        return native.zstd_compress_batch([raw], level)[0]


def zstd_unpack(blob: bytes, max_size: int) -> bytes:
    try:
        import zstandard
        return zstandard.ZstdDecompressor().decompress(
            blob, max_output_size=max_size)
    except ImportError:
        return native.zstd_decompress_batch([blob], [max_size])[0]


# ---- baseline codecs (error-bounded) ---------------------------------------

def quant_zstd(data: np.ndarray, eb: float):
    """Uniform scalar quantisation (step 2*eb) + zstd; |err| <= eb."""
    q = np.round(data / (2.0 * eb)).astype(np.int64)
    lo = q.min()
    enc = zstd_pack((q - lo).astype(np.uint32).tobytes())
    rec = ((q.astype(np.float64)) * 2.0 * eb).astype(np.float32)
    return len(enc) + 16, rec


def lorenzo_zstd(data: np.ndarray, eb: float):
    """2-D Lorenzo predictor + quantised correction + zstd; |err| <= eb.

    The SZ core: predict x[i,j] from the DECODED neighbours
    x[i-1,j] + x[i,j-1] - x[i-1,j-1], quantise the prediction error with
    step 2*eb, entropy-pack the quantised corrections.  Implemented
    row-sequentially on the decoded surface (exactly SZ's semantics).
    """
    d = data.astype(np.float64)
    h, w = d.shape
    step = 2.0 * eb
    rec = np.zeros((h, w))
    qs = np.zeros((h, w), np.int64)
    for i in range(h):
        up = rec[i - 1] if i else np.zeros(w)
        # row-sequential: rec[i, j-1] feeds the prediction of rec[i, j]
        prev = 0.0
        upleft = 0.0
        row = d[i]
        qrow = qs[i]
        rrow = rec[i]
        for j in range(w):
            pred = prev + up[j] - upleft
            q = round((row[j] - pred) / step)
            qrow[j] = q
            val = pred + q * step
            upleft = up[j]
            prev = val
            rrow[j] = val
    lo = qs.min()
    enc = zstd_pack((qs - lo).astype(np.uint32).tobytes())
    return len(enc) + 16, rec.astype(np.float32)


def run(data: np.ndarray, error: float, device="cuda"):
    """The table's rows (EBCC first) and the verdict, "PASS" or "FAIL"."""
    rows = []

    def add(name, size, rec, seconds):
        err = np.abs(rec.astype(np.float64) - data.astype(np.float64))
        rows.append(dict(
            method=name, bytes=int(size), cr=data.nbytes / size,
            rmse=float(np.sqrt(np.mean(err ** 2))),
            max_error=float(err.max()), seconds=round(seconds, 2)))
        print(json.dumps(rows[-1]))

    t0 = time.perf_counter()
    cfg = EBCCConfig(mode=ResidualMode.MAX_ERROR, error=error, base_cr=100,
                     max_batch=1)
    blob = api.compress(data, cfg, device=device)
    rec = api.decompress(blob, cfg, device=device).reshape(data.shape)
    add("ebcc_tpu", len(blob), rec, time.perf_counter() - t0)

    t0 = time.perf_counter()
    size, rec = quant_zstd(data, error)
    add("quant-zstd", size, rec, time.perf_counter() - t0)

    t0 = time.perf_counter()
    size, rec = lorenzo_zstd(data, error)
    add("lorenzo-zstd", size, rec, time.perf_counter() - t0)

    for name, packer in (("zstd(lossless)", lambda b: zstd_pack(b, 19)),
                         ("zlib(lossless)", lambda b: zlib.compress(b, 9))):
        t0 = time.perf_counter()
        size = len(packer(data.tobytes()))
        add(name, size, data, time.perf_counter() - t0)

    best_lossy = min(r["bytes"] for r in rows[1:3])
    verdict = "PASS" if rows[0]["bytes"] < best_lossy else "FAIL"
    print(f"\n{'method':<16}{'bytes':>10}{'CR':>8}{'RMSE':>10}"
          f"{'max_err':>10}{'s':>7}")
    for r in rows:
        print(f"{r['method']:<16}{r['bytes']:>10}{r['cr']:>8.1f}"
              f"{r['rmse']:>10.4f}{r['max_error']:>10.4f}"
              f"{r['seconds']:>7.2f}")
    print(f"\nEBCC-TPU vs best error-bounded baseline: {verdict} "
          f"({rows[0]['bytes']} vs {best_lossy} bytes at |err| <= {error})")
    return rows, verdict


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m ebcc_tpu_torch.scripts.compare_codecs",
        description=__doc__.split("\n\n")[0])
    p.add_argument("input", nargs="?", default=common.reference_path(),
                   help="the field (.npy); default: the frame "
                        f"${common.REFERENCE_FRAME_ENV} names")
    p.add_argument("--error", type=float, default=0.5,
                   help="absolute max-error bound (reference table: 10.0 "
                        "on geopotential; temperature scale ~0.5)")
    common.add_device_args(p, data=False)
    args = p.parse_args(argv)
    common.resolve_device(args.device)  # raises without a card
    if args.input is None:
        p.error(f"no input: pass a .npy field or set "
                f"{common.REFERENCE_FRAME_ENV}")
    data = np.load(args.input).astype(np.float32)
    data = data.reshape(-1, data.shape[-1])  # 2-D field
    _, verdict = run(data, args.error, args.device)
    return 0 if verdict == "PASS" else 1


if __name__ == "__main__":
    sys.exit(main())
