"""Video encode for animation frames.

The reference encodes PNG frames to H.264/mp4 with OpenH264 + minimp4
(main.rs:58-97). Backend ladder for `encode_mp4`:
  1. imageio/ffmpeg when present (H.264 mp4 — other machines);
  2. OpenCV VideoWriter with its built-in MPEG-4 codec + mp4 muxer
     (a real .mp4 without an external ffmpeg, fourcc "mp4v");
  3. the self-contained MJPEG-in-AVI writer below (RIFF container +
     JPEG frames via PIL) as the last resort.
"""
from __future__ import annotations

import struct
from io import BytesIO
from typing import Iterable, List

import numpy as np


def _jpeg_bytes(frame: np.ndarray, quality: int = 95) -> bytes:
    from PIL import Image

    buf = BytesIO()
    Image.fromarray(frame[:, :, :3]).save(buf, format="JPEG", quality=quality)
    data = buf.getvalue()
    if len(data) % 2:
        data += b"\x00"  # RIFF chunks are word-aligned
    return data


def write_mjpeg_avi(path: str, frames: Iterable[np.ndarray], fps: float, quality: int = 95):
    """frames: iterable of (H, W, 3) u8 RGB, top row first."""
    jpegs: List[bytes] = []
    w = h = None
    for f in frames:
        if w is None:
            h, w = f.shape[:2]
        jpegs.append(_jpeg_bytes(f, quality))
    if not jpegs:
        raise ValueError("no frames")
    n = len(jpegs)
    max_bytes = max(len(j) for j in jpegs)

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(payload)) + payload

    def lst(fourcc: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", fourcc + payload)

    usec_per_frame = int(round(1_000_000 / fps))
    avih = struct.pack(
        "<14I",
        usec_per_frame, max_bytes * int(fps), 0, 0x10,  # flags: HASINDEX
        n, 0, 1, max_bytes, w, h, 0, 0, 0, 0,
    )
    strh = b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIIII",
        0, 0, 0, 0, 1, int(round(fps)), 0, n, max_bytes, 0, 0xFFFFFFFF, 0
    ) + struct.pack("<4H", 0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)

    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_payload = b"".join(chunk(b"00dc", j) for j in jpegs)
    movi = lst(b"movi", movi_payload)

    # idx1: offsets are relative to the start of 'movi' fourcc
    idx_entries = []
    off = 4
    for j in jpegs:
        idx_entries.append(struct.pack("<4sIII", b"00dc", 0x10, off, len(j)))
        off += 8 + len(j)
    idx1 = chunk(b"idx1", b"".join(idx_entries))

    riff_payload = b"AVI " + hdrl + movi + idx1
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


def write_mp4_cv2(path: str, frames: List[np.ndarray], fps: float):
    """Real .mp4 via OpenCV's bundled MPEG-4 encoder + muxer (no
    external ffmpeg). Raises if cv2 is absent or refuses the codec."""
    import cv2

    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(
        path, cv2.VideoWriter_fourcc(*"mp4v"), float(fps), (w, h)
    )
    if not writer.isOpened():
        raise RuntimeError("cv2 VideoWriter could not open mp4v output")
    try:
        for f in frames:
            writer.write(f[:, :, 2::-1])  # RGB -> BGR
    finally:
        writer.release()
    import os

    if not os.path.getsize(path):
        raise RuntimeError("cv2 wrote an empty mp4")


def encode_mp4(path: str, frames: Iterable[np.ndarray], fps: float) -> str:
    """Encode to mp4 (imageio/ffmpeg, then OpenCV mp4v); fall back to
    MJPEG AVI next to the requested path. Returns the path written."""
    frames = list(frames)
    try:
        import imageio

        writer = imageio.get_writer(path, fps=fps)
        for f in frames:
            writer.append_data(f)
        writer.close()
        return path
    except Exception:
        pass
    try:
        write_mp4_cv2(path, frames, fps)
        return path
    except Exception:
        alt = path.rsplit(".", 1)[0] + ".avi"
        write_mjpeg_avi(alt, frames, fps)
        return alt
