"""Plain decoder of EBCC-TPU containers (format v4), the benchmark's
yardstick for what ``ebcc_tpu_torch.api.compress`` returns.

Written from ``docs/FORMAT.md`` in plain PyTorch, on whatever device the
tensors are given: the blob and frame headers, zstd (the system
``libzstd.so.1`` through ctypes), the bitplane structure decoded one plane
and one pass at a time with masks in place of the per-bit loop, midpoint
magnitudes, the per-subband synthesis-peak weights (worked out here from an
impulse, quantised to the 1/1024 grid), the CDF 9/7 inverse lifting with
its mirror boundaries, the DC, clamp, min-max unscale and the residual
layer.  The arithmetic is float32 step by step where the format's decoders
are; their fused multiply-adds are emulated in float64 and rounded once to
float32.  It imports nothing of ``ebcc_tpu_torch`` or ``ebcc_tpu`` and uses
no table the program made.
"""

from __future__ import annotations

import ctypes
import functools
import struct

import numpy as np
import torch

MAGIC_BLOB = b"EBTB"
MAGIC_FRAME = b"EBT1"
FLAG_CONST, FLAG_RESID, FLAG_POINTWISE, FLAG_BASE_Z = 1, 2, 4, 8
MASK_NONE = 0xFF
_HDR = struct.Struct("<4sBBHII ff fI B BBBBB BH")
_RES = struct.Struct("<fffBIQBH")

_F32 = np.float32
ALPHA, BETA = _F32(-1.586134342), _F32(-0.05298011854)
GAMMA, DELTA = _F32(0.8829110762), _F32(0.44355068522)
XI = _F32(1.149604398)
RECIP_XI = _F32(1.0 / np.float64(XI))
U16_MAX, RESID_SCALE = _F32(65535.0), _F32(255.0)
RECIP_U16 = _F32(1.0 / 65535.0)
RECIP_RS = _F32(1.0 / 255.0)


class CorruptFrame(ValueError):
    """A container that does not decode under the format."""


# ---- zstd -----------------------------------------------------------------

@functools.cache
def _zstd():
    lib = ctypes.CDLL("libzstd.so.1")
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_void_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p,
                                             ctypes.c_size_t]
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    return lib


def zstd_decompress(src: bytes, min_size: int) -> bytes:
    lib = _zstd()
    declared = lib.ZSTD_getFrameContentSize(src, len(src))
    cap = min_size if declared >= (1 << 63) else max(int(declared), min_size)
    dst = ctypes.create_string_buffer(max(cap, 1))
    n = lib.ZSTD_decompress(dst, cap, src, len(src))
    if lib.ZSTD_isError(n):
        raise CorruptFrame("zstd stream does not decode")
    return dst.raw[:n]


# ---- containers -----------------------------------------------------------

def split_blob(blob: bytes) -> list[bytes]:
    """The frames of an ``EBTB`` blob."""
    if len(blob) < 8 or blob[:4] != MAGIC_BLOB:
        raise CorruptFrame("not an EBTB blob")
    (n,) = struct.unpack_from("<I", blob, 4)
    lens = struct.unpack_from(f"<{n}Q", blob, 8)
    off = 8 + 8 * n
    if off + sum(lens) != len(blob):
        raise CorruptFrame("blob length does not match its index")
    out = []
    for ln in lens:
        out.append(blob[off:off + ln])
        off += ln
    return out


def parse_frame(buf: bytes) -> dict:
    """Header fields and streams of one version-4 frame."""
    if len(buf) < _HDR.size or buf[:4] != MAGIC_FRAME or buf[4] != 4:
        raise CorruptFrame("not a version-4 EBT1 frame")
    (_, _, flags, mode, h, w, mn, mx, dc_b, base_nbits, max_step_b, bl, rl,
     nc, bp, rp, bmp, bkeep) = _HDR.unpack_from(buf, 0)
    f = dict(flags=flags, mode=mode, h=h, w=w, mn=_F32(mn), mx=_F32(mx),
             dc_b=_F32(dc_b), base_nbits=base_nbits, max_step_b=max_step_b,
             base_levels=bl, resid_levels=rl, nchunks=nc, base_nplanes=bp,
             resid_nplanes=rp, base_mask=(bmp, bkeep), resid=None)
    off = _HDR.size
    if flags & FLAG_CONST:
        return f
    if flags & FLAG_RESID:
        rmin, rmax, dc_r, msr, rnbits, zlen, rmp, rkeep = _RES.unpack_from(
            buf, off)
        off += _RES.size
        z = buf[off:off + zlen]
        if len(z) != zlen:
            raise CorruptFrame("truncated residual stream")
        off += zlen
        f["resid"] = dict(rmin=_F32(rmin), rmax=_F32(rmax), dc=_F32(dc_r),
                          max_step=msr, nbits=rnbits, zstream=z,
                          mask=(rmp, rkeep))
    f["base_stream"] = buf[off:]
    return f


# ---- inverse CDF 9/7 ------------------------------------------------------

def _c(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _fma(a, b, c):
    """float32 fma(a, b, c): the exact product in float64, one add, one
    rounding to float32."""
    return (b.double() * float(a) + c.double()).float()


def _shift_prev(v):
    """v[i - 1], mirrored at the start (v[1] at i = 0)."""
    first = v[..., 1:2] if v.shape[-1] > 1 else v[..., :1]
    return torch.cat([first, v[..., :-1]], -1)


def _idwt_last(x):
    """Inverse lifting of [s | d] along the last axis (even length)."""
    n2 = x.shape[-1] // 2
    s = x[..., :n2] * _c(RECIP_XI, x)
    d = x[..., n2:] * _c(XI, x)
    s = _fma(-DELTA, d + _shift_prev(d), s)
    tail = s[..., n2 - 2:n2 - 1] if n2 >= 2 else s[..., :1]
    d = _fma(-GAMMA, s + torch.cat([s[..., 1:], tail], -1), d)
    s = _fma(-BETA, d + _shift_prev(d), s)
    d = _fma(-ALPHA, s + torch.cat([s[..., 1:], s[..., n2 - 1:]], -1), d)
    return torch.stack([s, d], -1).reshape(x.shape)


def idwt2d(x, levels: int):
    """Multi-level inverse transform of a Mallat layout [..., H, W]:
    deepest level first, columns then rows."""
    x = x.clone()
    hgt, wid = x.shape[-2:]
    for i in range(levels - 1, -1, -1):
        hh, ww = hgt >> i, wid >> i
        reg = x[..., :hh, :ww]
        reg = _idwt_last(reg.transpose(-1, -2)).transpose(-1, -2)
        x[..., :hh, :ww] = _idwt_last(reg)
    return x


def subband_map(h: int, w: int, levels: int) -> np.ndarray:
    """Subband id per coefficient: 0 the deepest LL; per level i (0 the
    shallowest) HL 3i+1, LH 3i+2, HH 3i+3."""
    m = np.zeros((h, w), np.int64)
    for i in range(levels):
        hh, ww = h >> i, w >> i
        m[:hh // 2, ww // 2:ww] = 3 * i + 1
        m[hh // 2:hh, :ww // 2] = 3 * i + 2
        m[hh // 2:hh, ww // 2:ww] = 3 * i + 3
    return m


@functools.cache
def subband_weights(levels: int) -> np.ndarray:
    """Per subband: the peak |amplitude| of its synthesis basis (an impulse
    at the subband's middle coefficient in row-major order, on a grid of
    2**(levels + 3)), rounded half to even on the 1/1024 grid, clamped to
    [1/8, 8] and divided by the smallest."""
    n = 1 << (levels + 3)
    smap = subband_map(n, n, levels)
    peaks = np.zeros(3 * levels + 1, np.float32)
    for sid in range(3 * levels + 1):
        ys, xs = np.nonzero(smap == sid)
        imp = torch.zeros((n, n), dtype=torch.float32)
        imp[ys[len(ys) // 2], xs[len(xs) // 2]] = 1.0
        peak = float(idwt2d(imp, levels).abs().max())
        peaks[sid] = np.float32(np.round(np.float64(peak) * 1024.0) / 1024.0)
    peaks = np.clip(peaks, _F32(0.125), _F32(8.0))
    return (peaks / peaks.min()).astype(np.float32)


@functools.cache
def _weight_plane(hp: int, wp: int, levels: int, device: str):
    return torch.from_numpy(
        subband_weights(levels)[subband_map(hp, wp, levels)]).to(device)


# ---- bitplane structure ---------------------------------------------------

def _up(sig):
    return sig.repeat_interleave(2, 0).repeat_interleave(2, 1)


class _Bits:
    """An MSB-first bit stream of ``nbits`` bits; reads past the end give 0."""

    def __init__(self, stream: bytes, nbits: int, device):
        if len(stream) * 8 < nbits:
            raise CorruptFrame("stream shorter than its declared bits")
        raw = np.unpackbits(np.frombuffer(stream, np.uint8))[:nbits]
        self.nbits = nbits
        self.bits = torch.from_numpy(raw.astype(np.int64)).to(device)
        self.ones = torch.zeros(nbits + 1, dtype=torch.int64, device=device)
        self.ones[1:] = torch.cumsum(self.bits, 0)
        self._ones_host = None

    def read(self, pos):
        ok = pos < self.nbits
        if self.nbits == 0:
            return torch.zeros_like(pos), ok
        vals = self.bits[pos.clamp(max=self.nbits - 1)]
        return torch.where(ok, vals, torch.zeros_like(vals)), ok

    def count_ones(self, lo: int, hi: int) -> int:
        if self._ones_host is None:
            self._ones_host = self.ones.cpu().numpy()
        lo, hi = min(lo, self.nbits), min(hi, self.nbits)
        return int(self._ones_host[hi] - self._ones_host[lo])


def _chunk_rows(hp: int, nchunks: int):
    bounds = [(j * hp + nchunks - 1) // nchunks for j in range(nchunks + 1)]
    of_row = np.zeros(hp, np.int64)
    for j in range(nchunks):
        of_row[bounds[j]:bounds[j + 1]] = j
    return of_row


def _pass_positions(cand, chunk_of_row, keep, starts):
    """Bit positions of the candidates of one level-0 pass, row-major
    within each chunk and chunk after chunk; ``starts[j]`` is chunk j's
    first bit.  Returns (flat indices, their chunk, positions)."""
    wp = cand.shape[1]
    idx = cand.flatten().nonzero().squeeze(1)
    ch = chunk_of_row[idx // wp]
    counts = torch.bincount(ch, minlength=len(keep))
    before = torch.cumsum(counts, 0) - counts
    rank = torch.arange(idx.numel(), device=idx.device) - before[ch]
    return idx, ch, starts[ch] + rank


def decode_coefficients(stream: bytes, nbits: int, max_step: int, hp: int,
                        wp: int, levels: int, nplanes: int, nchunks: int,
                        mask: tuple, device) -> torch.Tensor:
    """One layer's bitstream -> midpoint-reconstructed weighted
    coefficients, float32 [hp, wp]."""
    g = levels + 1
    bits = _Bits(stream, nbits, device)
    mask_plane, keep_mask = mask
    if mask_plane != MASK_NONE and mask_plane >= nplanes:
        raise CorruptFrame("mask plane beyond the layer's planes")
    sig = {k: torch.zeros((hp >> k, wp >> k), dtype=torch.bool,
                          device=device) for k in range(1, g + 1)}
    sig0 = torch.zeros((hp, wp), dtype=torch.bool, device=device)
    mag = torch.zeros(hp * wp, dtype=torch.int64, device=device)
    neg = torch.zeros(hp * wp, dtype=torch.bool, device=device)
    last = torch.full((hp * wp,), nplanes, dtype=torch.int64, device=device)
    newp = torch.full((hp, wp), -1, dtype=torch.int64, device=device)
    of_row_np = _chunk_rows(hp, nchunks)
    of_row = torch.from_numpy(of_row_np).to(device)
    pos = 0
    for b in range(nplanes - 1, -1, -1):
        if pos >= nbits:
            break
        for k in range(g, 0, -1):
            if k == g:
                if max_step < b:
                    continue
                cand = ~sig[g]
            else:
                cand = _up(sig[k + 1]) & ~sig[k]
            idx = cand.flatten().nonzero().squeeze(1)
            n = idx.numel()
            if n:
                v, _ = bits.read(pos + torch.arange(n, device=device))
                sig[k].view(-1)[idx[v.bool()]] = True
            pos += n
        keep = [not (b == mask_plane and not (keep_mask >> j) & 1)
                for j in range(nchunks)]
        rowkeep = torch.tensor(keep, device=device)[of_row][:, None]
        # significance bits, then the signs of what became significant
        cand = _up(sig[1]) & ~sig0 & rowkeep
        counts = np.bincount(of_row_np, weights=cand.sum(1).cpu().numpy(),
                             minlength=nchunks).astype(np.int64)
        sig_start, sign_start, nnew = [], [], []
        for j in range(nchunks):
            c = int(counts[j])
            ones = bits.count_ones(pos, pos + c)
            sig_start.append(pos)
            sign_start.append(pos + c)
            nnew.append(ones)
            pos += c + ones
        idx, ch, bpos = _pass_positions(
            cand, of_row, keep, torch.tensor(sig_start, device=device))
        if idx.numel():
            v, _ = bits.read(bpos)
            new = v.bool()
            nidx, nch = idx[new], ch[new]
            sig0.view(-1)[nidx] = True
            mag[nidx] = 1 << b
            last[nidx] = b
            newp.view(-1)[nidx] = b
            nn = torch.tensor(nnew, device=device)
            before = torch.cumsum(nn, 0) - nn
            rank = torch.arange(nidx.numel(), device=device) - before[nch]
            s, _ = bits.read(torch.tensor(sign_start, device=device)[nch]
                             + rank)
            neg[nidx] = s.bool()
        # refinement bits of the coefficients significant before this plane
        cand = sig0 & (newp != b) & rowkeep
        counts = np.bincount(of_row_np, weights=cand.sum(1).cpu().numpy(),
                             minlength=nchunks).astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]]) + pos
        pos += int(counts.sum())
        idx, _, bpos = _pass_positions(
            cand, of_row, keep, torch.from_numpy(starts).to(device))
        if idx.numel():
            v, ok = bits.read(bpos)
            sel = idx[ok]
            mag[sel] |= v[ok] << b
            last[sel] = b
    half = torch.where(last > 0, (torch.ldexp(torch.ones_like(
        last, dtype=torch.float32), last.float()) - 1.0) * 0.5,
        torch.zeros((), device=device))
    val = mag.float() + half
    val = torch.where(neg, -val, val)
    return torch.where(sig0.flatten(), val, torch.zeros_like(val)).view(
        hp, wp)


def _padded(n: int, levels: int) -> int:
    m = 1 << (levels + 1)
    return (n + m - 1) // m * m


def _layer(stream, nbits, max_step, h, w, levels, nplanes, nchunks, mask,
           dc, hi, device):
    hp, wp = _padded(h, levels), _padded(w, levels)
    coef = decode_coefficients(stream, nbits, max_step, hp, wp, levels,
                               nplanes, nchunks, mask, device)
    y = idwt2d(coef / _weight_plane(hp, wp, levels, str(device)), levels)
    y = (y + _c(dc, y)).clamp(min=0.0).minimum(_c(hi, y))
    return y[:h, :w]


def decode_frame(buf: bytes, device="cpu") -> torch.Tensor:
    """One frame -> float32 [h, w] on ``device``."""
    f = parse_frame(buf)
    h, w = f["h"], f["w"]
    if f["flags"] & FLAG_CONST:
        return torch.full((h, w), float(f["mn"]), dtype=torch.float32,
                          device=device)
    base = f["base_stream"]
    nbytes = (f["base_nbits"] + 7) // 8
    if f["flags"] & FLAG_BASE_Z:
        base = zstd_decompress(base, nbytes)
    y = _layer(base, f["base_nbits"], f["max_step_b"], h, w,
               f["base_levels"], f["base_nplanes"], f["nchunks"],
               f["base_mask"], f["dc_b"], U16_MAX, device)
    out = _fma(_F32(RECIP_U16 * (f["mx"] - f["mn"])), y,
               torch.full_like(y, float(f["mn"])))
    r = f["resid"]
    if r is not None:
        raw = zstd_decompress(r["zstream"], (r["nbits"] + 7) // 8)
        y = _layer(raw, r["nbits"], r["max_step"], h, w, f["resid_levels"],
                   f["resid_nplanes"], f["nchunks"], r["mask"], r["dc"],
                   RESID_SCALE, device)
        out = out + _fma(_F32(RECIP_RS * (r["rmax"] - r["rmin"])), y,
                         torch.full_like(y, float(r["rmin"])))
    return out
