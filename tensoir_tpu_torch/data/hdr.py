"""Radiance .hdr (RGBE) read and write in numpy (the port's own copy of
tensoir_tpu.data.hdr). Files laid out X-major (``-X``/``+X`` first), or
without a Radiance signature, raise: the JAX package reads those through
imageio, which the port does not use."""
from __future__ import annotations

import numpy as np


def read_hdr(path: str) -> np.ndarray:
    """Load a Radiance RGBE .hdr file -> float32 [H, W, 3] linear RGB."""
    with open(path, "rb") as fh:
        data = fh.read()

    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        _unsupported(path, "no #?RADIANCE / #?RGBE signature")
    pos = 0
    width = height = None
    flip_y = False
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line.startswith(b"-Y") or line.startswith(b"+Y"):
            # '-Y H +X W' is the standard top-down layout; '+Y' stores
            # scanlines bottom-up (flipped after the decode)
            parts = line.split()
            height, width = int(parts[1]), int(parts[3])
            flip_y = line.startswith(b"+Y")
            break
        if line.startswith(b"-X") or line.startswith(b"+X"):
            _unsupported(path, f"X-major layout {line.decode(errors='replace')}")

    rgbe = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bpos = 0
    for y in range(height):
        if (width < 8 or width > 0x7FFF or buf[bpos] != 2 or buf[bpos + 1] != 2
                or (buf[bpos + 2].astype(int) << 8 | buf[bpos + 3]) != width):
            # flat (uncompressed) scanlines for the rest of the image
            n = (height - y) * width
            flat = buf[bpos:bpos + n * 4].reshape(-1, 4)
            rgbe[y:] = flat.reshape(height - y, width, 4)
            bpos += n * 4
            break
        bpos += 4
        # new-style RLE: 4 channel-planes per scanline
        for c in range(4):
            x = 0
            while x < width:
                count = int(buf[bpos]); bpos += 1
                if count > 128:  # run
                    rgbe[y, x:x + count - 128, c] = buf[bpos]
                    bpos += 1
                    x += count - 128
                else:            # literal
                    rgbe[y, x:x + count, c] = buf[bpos:bpos + count]
                    bpos += count
                    x += count
    if flip_y:
        rgbe = rgbe[::-1]
    return rgbe_to_float(rgbe)


def _unsupported(path: str, why: str):
    raise ValueError(f"{path}: unsupported Radiance file ({why}); the port "
                     f"reads '-Y H +X W' and '+Y H +X W' layouts")


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    exp = rgbe[..., 3].astype(np.int32)
    # scale is already 0 where exp == 0 (the RGBE zero encoding)
    scale = np.where(exp == 0, 0.0,
                     np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None]


def write_hdr(path: str, img: np.ndarray):
    """Write float32 [H, W, 3] linear RGB as uncompressed RGBE."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    maxc = img.max(-1)
    exp = np.zeros_like(maxc, np.int32)
    mant = np.zeros_like(img)
    nz = maxc > 1e-32
    f, e = np.frexp(maxc[nz])
    # float2rgbe: mantissa = v / 2^e * 256
    mant[nz] = img[nz] / maxc[nz][..., None] * f[..., None] * 256.0
    exp[nz] = e
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(mant, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.clip(exp + 128, 0, 255).astype(np.uint8)
    with open(path, "wb") as fh:
        fh.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        fh.write(f"-Y {h} +X {w}\n".encode())
        fh.write(rgbe.tobytes())
