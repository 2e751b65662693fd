"""Sample compression codecs.

Deep Lake compresses *samples* (not whole chunks) so that ranged reads can
decompress a single sample without touching the rest of the chunk (§3.4/§3.5).
Offline container ⇒ no libjpeg/ffmpeg; the codec set is:

    raw     -- np.tobytes, zero-copy decode
    zlib    -- DEFLATE (stdlib), lossless; stands in for PNG-class codecs
    lzma    -- higher-ratio lossless; stands in for archival codecs
    quant8  -- lossy 8-bit min/max quantization + zlib; stands in for
               JPEG-class lossy image compression (benchmarks use it for the
               "jpeg" datasets of Fig 5)

Codecs encode a single ndarray to bytes and back; dtype/shape travel in the
chunk header, NOT in the codec payload (except quant8's dequant scale).
"""

from __future__ import annotations

import struct
import zlib
import lzma
from typing import Dict, Tuple

import numpy as np


class Codec:
    name: str = "abstract"
    lossy: bool = False

    def encode(self, arr: np.ndarray) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes, shape: Tuple[int, ...], dtype: np.dtype) -> np.ndarray:
        raise NotImplementedError


class RawCodec(Codec):
    name = "raw"

    def encode(self, arr: np.ndarray) -> bytes:
        return np.ascontiguousarray(arr).tobytes()

    def decode(self, data: bytes, shape, dtype) -> np.ndarray:
        return np.frombuffer(data, dtype=dtype).reshape(shape)


class ZlibCodec(Codec):
    name = "zlib"

    def __init__(self, level: int = 1) -> None:
        self.level = level

    def encode(self, arr: np.ndarray) -> bytes:
        return zlib.compress(np.ascontiguousarray(arr).tobytes(), self.level)

    def decode(self, data: bytes, shape, dtype) -> np.ndarray:
        return np.frombuffer(zlib.decompress(data), dtype=dtype).reshape(shape)


class LzmaCodec(Codec):
    name = "lzma"

    def encode(self, arr: np.ndarray) -> bytes:
        return lzma.compress(np.ascontiguousarray(arr).tobytes(), preset=0)

    def decode(self, data: bytes, shape, dtype) -> np.ndarray:
        return np.frombuffer(lzma.decompress(data), dtype=dtype).reshape(shape)


class Quant8Codec(Codec):
    """Lossy min/max 8-bit quantization + DEFLATE.  JPEG-class stand-in.

    Payload: f64 lo | f64 hi | zlib(uint8 quantized).  Roundtrip error is
    bounded by (hi-lo)/255, analogous to JPEG quality loss.
    """

    name = "quant8"
    lossy = True

    def encode(self, arr: np.ndarray) -> bytes:
        a = np.ascontiguousarray(arr)
        if a.dtype == np.uint8:  # already 8-bit: just deflate
            lo, hi = 0.0, 255.0
            q = a
        else:
            af = a.astype(np.float64)
            lo = float(af.min()) if a.size else 0.0
            hi = float(af.max()) if a.size else 0.0
            scale = (hi - lo) or 1.0
            q = np.round((af - lo) / scale * 255.0).astype(np.uint8)
        return struct.pack("<dd", lo, hi) + zlib.compress(q.tobytes(), 1)

    def decode(self, data: bytes, shape, dtype) -> np.ndarray:
        lo, hi = struct.unpack("<dd", data[:16])
        q = np.frombuffer(zlib.decompress(data[16:]), dtype=np.uint8).reshape(shape)
        if np.dtype(dtype) == np.uint8 and lo == 0.0 and hi == 255.0:
            return q
        scale = (hi - lo) or 1.0
        return (q.astype(np.float64) / 255.0 * scale + lo).astype(dtype)


_REGISTRY: Dict[str, Codec] = {}


def register(codec: Codec) -> Codec:
    _REGISTRY[codec.name] = codec
    return codec


register(RawCodec())
register(ZlibCodec())
register(LzmaCodec())
register(Quant8Codec())


def get_codec(name: str) -> Codec:
    try:
        return _REGISTRY[name or "raw"]
    except KeyError:
        raise ValueError(f"unknown codec {name!r}; have {sorted(_REGISTRY)}") from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
