"""A minimal MJPEG-in-AVI writer (stdlib ``struct``; frames JPEG-encoded by
``cv2.imencode``).

The reference's video task pipes its frames through ffmpeg/libx264
(run_scade_scannet.py:236-264). Where neither ffmpeg nor an mp4 backend of
imageio exists, ``eval/evaluate.py::render_video`` writes the frames as an
MJPEG AVI instead: a RIFF container whose ``00dc`` chunks are plain baseline
JPEGs, which VLC, ffmpeg, QuickTime and ``cv2.VideoCapture`` read
(``ffmpeg -i out.avi out.mp4`` converts it later). The same container as the
JAX package's ``scade_tpu/utils/video.py`` writes.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    data = struct.pack("<4sI", fourcc, len(payload)) + payload
    if len(payload) % 2:
        data += b"\x00"  # RIFF chunks are word-aligned
    return data


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_mjpeg_avi(
    path: str,
    jpeg_frames: Sequence[bytes],
    size: Tuple[int, int],
    fps: int = 25,
) -> str:
    """Write JPEG-encoded frames, all of one (width, height), as an AVI.

    jpeg_frames: one JPEG byte string per frame (e.g. from cv2.imencode).
    size:        (width, height) of every frame.
    """
    w, h = size
    n = len(jpeg_frames)
    max_bytes = max((len(f) for f in jpeg_frames), default=0)

    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(1_000_000 / max(fps, 1)),  # dwMicroSecPerFrame
        max_bytes * fps,               # dwMaxBytesPerSec
        0,                             # dwPaddingGranularity
        0x10,                          # dwFlags: AVIF_HASINDEX
        n,                             # dwTotalFrames
        0, 1,                          # dwInitialFrames, dwStreams
        max_bytes,                     # dwSuggestedBufferSize
        w, h,
        0, 0, 0, 0,                    # dwReserved
    )
    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh",
        b"vids", b"MJPG",
        0,                             # dwFlags
        0, 0,                          # wPriority, wLanguage
        0,                             # dwInitialFrames
        1, fps,                        # dwScale, dwRate
        0, n, max_bytes,               # dwStart, dwLength, dwSuggestedBufferSize
        0xFFFFFFFF, 0,                 # dwQuality, dwSampleSize
        0, 0, w, h,                    # rcFrame
    )
    strf = struct.pack(
        "<IiiHH4sIiiII",
        40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0,
    )
    hdrl = _list(
        b"hdrl",
        _chunk(b"avih", avih) + _list(b"strl", _chunk(b"strh", strh) + _chunk(b"strf", strf)),
    )

    movi_chunks: List[bytes] = []
    index_entries: List[bytes] = []
    offset = 4  # relative to the start of the 'movi' fourcc
    for jpg in jpeg_frames:
        ch = _chunk(b"00dc", jpg)
        movi_chunks.append(ch)
        index_entries.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(jpg)))
        offset += len(ch)
    movi = _list(b"movi", b"".join(movi_chunks))
    idx1 = _chunk(b"idx1", b"".join(index_entries))

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as fp:
        fp.write(struct.pack("<4sI", b"RIFF", len(riff_payload)) + riff_payload)
    return path


def encode_frames_bgr(frames, quality: int = 95) -> List[bytes]:
    """BGR uint8 frames → one JPEG byte string each (cv2.imencode)."""
    import cv2

    out = []
    for f in frames:
        ok, buf = cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise RuntimeError("cv2.imencode failed")
        out.append(buf.tobytes())
    return out
