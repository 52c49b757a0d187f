"""Image IO — PNG and BMP readers/writers in NumPy.

A copy of ``fypraytracer_tpu/utils/image.py``: scanlines are
reconstructed by the C++ unfilter of ``accel/native.py`` where it builds,
else in NumPy, as the JAX package does.  Enough to read the committed
goldens (``benchmarks/goldens/*.png``), the room's textures, and write
renders.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def save_bmp(path: str, rgb8: np.ndarray) -> None:
    """Write (H, W, 3) uint8 RGB as a 24-bit bottom-up BMP
    (MisUtils.cpp:13-95 layout: BGR pixel order, rows padded to 4 bytes)."""
    h, w = rgb8.shape[:2]
    row_bytes = (w * 3 + 3) & ~3
    img_size = row_bytes * h
    header = struct.pack("<2sIHHI", b"BM", 54 + img_size, 0, 0, 54)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, img_size, 2835, 2835, 0, 0)
    bgr = rgb8[::-1, :, ::-1]  # bottom-up rows, BGR channels
    pad = np.zeros((h, row_bytes - w * 3), np.uint8)
    body = np.concatenate([bgr.reshape(h, -1), pad], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(header + info + body)


def load_bmp(path: str) -> np.ndarray:
    """Read a 24-bit BMP back to (H, W, 3) uint8 RGB (row flip applied,
    as MisUtils.cpp:129-137 does for comparisons)."""
    data = open(path, "rb").read()
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    offset = struct.unpack_from("<I", data, 10)[0]
    w = struct.unpack_from("<i", data, 18)[0]
    h = struct.unpack_from("<i", data, 22)[0]
    bpp = struct.unpack_from("<H", data, 28)[0]
    if bpp != 24:
        raise ValueError(f"only 24-bit BMP supported, got {bpp}")
    row_bytes = (w * 3 + 3) & ~3
    arr = np.frombuffer(data, np.uint8, count=row_bytes * abs(h), offset=offset)
    arr = arr.reshape(abs(h), row_bytes)[:, : w * 3].reshape(abs(h), w, 3)
    if h > 0:
        arr = arr[::-1]  # bottom-up -> top-down
    return arr[:, :, ::-1].copy()  # BGR -> RGB


def _png_unfilter_numpy(raw: np.ndarray, height: int, stride: int,
                        bpp: int) -> np.ndarray:
    """NumPy scanline reconstruction, the fallback of the native unfilter
    (same semantics as native/builders.cpp::png_unfilter).  None/Up rows
    are vectorized; Sub rows use a per-channel cumsum; Average/Paeth rows
    use a per-byte loop (correct but slow)."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    for y in range(height):
        ftype = int(rows[y, 0])
        src = rows[y, 1:]
        up = out[y - 1] if y else np.zeros(stride, np.uint8)
        if ftype == 0:
            out[y] = src
        elif ftype == 1:  # Sub: per-channel cumsum mod 256
            cols = src.reshape(-1, bpp)
            out[y] = np.cumsum(cols.astype(np.uint64), axis=0).astype(
                np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            out[y] = src + up
        elif ftype in (3, 4):  # Average / Paeth: sequential in x
            cur = out[y]
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(up[x])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[x - bpp]) if (y and x >= bpp) else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (int(src[x]) + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
    return out.reshape(-1)


def load_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG to (H, W, C) uint8.

    Framework-owned decoder (stb_image parity for the reference's texture
    loading, Texture.cu:8-40): chunk parse + stdlib zlib inflate here,
    scanline unfiltering in native C++ (NumPy fallback).  Supports color
    types 0 (gray), 2 (RGB), 3 (palette), 4 (gray+alpha), 6 (RGBA) at bit
    depth 8 — covers the reference's assets (RGB + RGBA, 2048²).
    """
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, w = 8, 0
    idat = bytearray()
    palette = None
    h = bitdepth = ctype = interlace = 0
    while pos + 8 <= len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, bitdepth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
        elif tag == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if bitdepth != 8:
        raise ValueError(f"only 8-bit PNG supported, got {bitdepth}")
    if interlace:
        raise ValueError("interlaced PNG not supported")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(bytes(idat)), np.uint8)
    if len(raw) != h * (stride + 1):
        raise ValueError("PNG IDAT size mismatch")
    from fypraytracer_tpu_torch.accel.native import png_unfilter_native

    out = png_unfilter_native(raw, h, stride, channels)
    if out is None:
        out = _png_unfilter_numpy(raw, h, stride, channels)
    img = out.reshape(h, w, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE chunk")
        img = palette[img[:, :, 0]]
    return img


def load_image(path: str) -> np.ndarray:
    """Load a BMP or PNG to (H, W, 3) uint8 RGB by magic bytes (the role of
    stbi_load in the reference's Scene::AddNewTexture, Scene.cpp:188)."""
    magic = open(path, "rb").read(8)
    if magic[:2] == b"BM":
        return load_bmp(path)
    img = load_png(path)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    elif img.shape[-1] == 2:
        img = np.repeat(img[:, :, :1], 3, axis=-1)
    return img[:, :, :3].copy()


def save_png(path: str, rgb8: np.ndarray) -> None:
    """Minimal PNG writer (no external deps)."""
    h, w = rgb8.shape[:2]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
