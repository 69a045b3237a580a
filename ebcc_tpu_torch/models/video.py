"""Video-codec baseline compressor (ffmpeg x264/x265/vp9).

A copy of ``ebcc_tpu.models.video`` (numpy and ffmpeg only, no framework
code).  Parity port of capability of ``FFmpegVideoArrayCompressor``
(video_wrapper.py:33-158): a [N, H, W] float32 array in [0, 1] is
quantised to uint8 grayscale rawvideo, piped through ffmpeg at a CRF, and
decoded back via ffprobe+ffmpeg.  This is a lossy
*baseline* for comparison plots, not an error-bounded codec.

The ffmpeg binary is not present in every image; construction raises a clear
error when unavailable (check :func:`available` first).
"""

from __future__ import annotations

import json
import shutil
import struct
import subprocess

import numpy as np

_CODEC_ARGS = {
    "x264": ["-c:v", "libx264", "-preset", "slow"],
    "x265": ["-c:v", "libx265", "-preset", "slow"],
    "vp9": ["-c:v", "libvpx-vp9", "-b:v", "0"],
}

_MAGIC = b"EBTV"


def available() -> bool:
    return shutil.which("ffmpeg") is not None


class VideoArrayCompressor:
    """[N, H, W] float32 in [0, 1] <-> video bytes (video_wrapper.py:33)."""

    def __init__(self, codec: str = "x264", crf: int = 23):
        if not available():
            raise RuntimeError("ffmpeg binary not found on PATH")
        if codec not in _CODEC_ARGS:
            raise ValueError(f"codec must be one of {sorted(_CODEC_ARGS)}")
        self.codec = codec
        self.crf = int(crf)

    def compress(self, data) -> bytes:
        data = np.asarray(data, np.float32)
        if data.ndim != 3:
            raise ValueError("expected [N, H, W]")
        n, h, w = data.shape
        raw = np.clip(data * 255.0, 0, 255).astype(np.uint8).tobytes()
        cmd = ["ffmpeg", "-y", "-f", "rawvideo", "-pix_fmt", "gray",
               "-s", f"{w}x{h}", "-r", "25", "-i", "pipe:0",
               *_CODEC_ARGS[self.codec], "-crf", str(self.crf),
               "-f", "matroska", "pipe:1"]
        out = subprocess.run(cmd, input=raw, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, check=True).stdout
        return struct.pack("<4sIII", _MAGIC, n, h, w) + out

    def decompress(self, blob: bytes) -> np.ndarray:
        magic, n, h, w = struct.unpack_from("<4sIII", blob, 0)
        if magic != _MAGIC:
            raise ValueError("not a VideoArrayCompressor blob")
        video = blob[struct.calcsize("<4sIII"):]
        cmd = ["ffmpeg", "-i", "pipe:0", "-f", "rawvideo",
               "-pix_fmt", "gray", "pipe:1"]
        raw = subprocess.run(cmd, input=video, stdout=subprocess.PIPE,
                             stderr=subprocess.DEVNULL, check=True).stdout
        arr = np.frombuffer(raw[: n * h * w], np.uint8).reshape(n, h, w)
        return arr.astype(np.float32) / 255.0
