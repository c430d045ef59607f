"""Reading and writing the scene's and the results' images.

With ``cv2`` importable, every function calls it exactly as the JAX package
does (``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` and a BGR↔RGB swap). Without
it, PNG goes through this module's own ``zlib`` + numpy codec: non-interlaced,
8-bit gray/RGB/RGBA (and gray+alpha) and 16-bit gray (and 16-bit colour),
every filter type on reading (None, Sub and Up vectorized, Average and Paeth
row by row), filter Up on writing. PNG is lossless, so both routes give the
same arrays. This is a route around a missing library with identical
results, not a fallback of the device: nothing here touches a tensor.

JPEG needs ``cv2``: without it, reading or writing one raises an error that
names the file. Nothing is substituted.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def jpeg_available() -> bool:
    return cv2 is not None


def _is_png(path: str) -> bool:
    return os.path.splitext(path)[1].lower() == ".png"


def _no_cv2(path: str, what: str):
    return RuntimeError(f"{path}: {what} needs OpenCV (cv2), which is not installed; "
                        "only PNG is read and written without it")


def _imread_unchanged(path: str) -> np.ndarray:
    """The image as cv2.imread(path, IMREAD_UNCHANGED) gives it: HxW or HxWxC,
    colour channels in BGR(A) order, uint8 or uint16."""
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if not _is_png(path):
        raise _no_cv2(path, "reading this image")
    img = png_decode(path)
    if img.ndim == 3 and img.shape[-1] in (3, 4):
        img = np.ascontiguousarray(img[..., [2, 1, 0, 3][: img.shape[-1]]])
    return img


def read_image(path: str) -> np.ndarray:
    """RGB(A) image as float32 in [0, 1], as the JAX package's read_files
    computes it (uint8 / 255.0 in float64, then float32)."""
    img = _imread_unchanged(path)
    if img.ndim != 3 or img.shape[-1] not in (3, 4):
        raise ValueError(f"{path}: expected a 3- or 4-channel image, got shape {img.shape}")
    if cv2 is not None:
        convert = cv2.COLOR_BGRA2RGBA if img.shape[-1] == 4 else cv2.COLOR_BGR2RGB
        img = cv2.cvtColor(img, convert)
    else:
        img = img[..., [2, 1, 0, 3][: img.shape[-1]]]
    return (img / 255.0).astype(np.float32)


def read_depth_png(path: str) -> np.ndarray:
    """A depth map as stored (uint16, HxW for a 16-bit gray PNG)."""
    return _imread_unchanged(path)


def write_png8(path: str, img: np.ndarray) -> None:
    """uint8 HxW gray or HxWx3 RGB."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"{path}: write_png8 takes uint8, got {img.dtype}")
    if cv2 is not None:
        _cv2_write(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR) if img.ndim == 3 else img)
    else:
        png_encode(path, img)


def write_png16(path: str, img: np.ndarray) -> None:
    """uint16 HxW gray."""
    img = np.asarray(img)
    if img.dtype != np.uint16 or img.ndim != 2:
        raise TypeError(f"{path}: write_png16 takes a 2-D uint16 array, got {img.dtype} "
                        f"{img.shape}")
    if cv2 is not None:
        _cv2_write(path, img)
    else:
        png_encode(path, img)


def write_rgb_jpg(path: str, img: np.ndarray) -> None:
    """uint8 HxWx3 RGB as JPEG through cv2 (its default quality)."""
    if cv2 is None:
        raise _no_cv2(path, "writing a JPEG")
    _cv2_write(path, cv2.cvtColor(np.asarray(img), cv2.COLOR_RGB2BGR))


def _cv2_write(path: str, img: np.ndarray) -> None:
    if not cv2.imwrite(path, img):
        raise OSError(f"{path}: cv2.imwrite failed")


# ---- the PNG codec ---------------------------------------------------------


def png_encode(path: str, img: np.ndarray, level: int = 6) -> None:
    """Writes uint8 or uint16 HxW, HxWx3 or HxWx4 (RGB(A) order) as a PNG.
    Every row but the first takes filter Up, the first filter None."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"{path}: PNG takes uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    depth = 8 * img.dtype.itemsize
    rows = img.astype(img.dtype.newbyteorder(">"), copy=False).reshape(h, -1).view(np.uint8)
    filtered = np.empty((h, rows.shape[1] + 1), np.uint8)
    filtered[:, 0] = 2
    filtered[0, 0] = 0
    filtered[0, 1:] = rows[0]
    filtered[1:, 1:] = rows[1:] - rows[:-1]  # wraps mod 256
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        for tag, data in ((b"IHDR", ihdr), (b"IDAT", zlib.compress(filtered.tobytes(), level)),
                          (b"IEND", b"")):
            f.write(struct.pack(">I", len(data)) + tag + data)
            f.write(struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_decode(path: str) -> np.ndarray:
    """A PNG as a uint8 or uint16 array, HxW or HxWxC in the file's own
    (RGB(A)) channel order."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", chunk)
        elif tag == b"IDAT":
            idat.append(chunk)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if colour not in _CHANNELS or depth not in (8, 16) or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (colour type {colour}, bit depth {depth}, "
                         f"interlace {interlace}); the codec reads non-interlaced 8/16-bit "
                         "gray, gray+alpha, RGB and RGBA")
    c = _CHANNELS[colour]
    bpp = c * depth // 8  # bytes per pixel, the filters' left neighbour distance
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    out = _unfilter(raw[:, 0], raw[:, 1:], bpp, path)
    dtype = np.dtype(">u2") if depth == 16 else np.dtype(np.uint8)
    img = out.view(dtype).reshape(h, w, c).astype(dtype.newbyteorder("="))
    return img[..., 0] if c == 1 else img


def _unfilter(types: np.ndarray, rows: np.ndarray, bpp: int, path: str) -> np.ndarray:
    h, stride = rows.shape
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        t, line = int(types[r]), rows[r]
        if t == 0:  # None
            cur = line.copy()
        elif t == 1:  # Sub: running sum over pixels, per byte of a pixel
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint64) % 256)
            cur = cur.astype(np.uint8).reshape(-1)
        elif t == 2:  # Up
            cur = line + prev
        elif t == 3:  # Average of left and up, left to right
            cur, up = line.tolist(), prev.tolist()
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + up[x]) >> 1)) & 0xFF
            cur = np.array(cur, np.uint8)
        elif t == 4:  # Paeth, left to right
            cur, up = line.tolist(), prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                c = up[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.array(cur, np.uint8)
        else:
            raise ValueError(f"{path}: PNG row {r} has filter type {t}")
        out[r] = cur
        prev = cur
    return out
