"""PNG read and write with zlib and numpy only (the machine with the card
has neither PIL nor imageio).

The reader takes non-interlaced files at bit depth 8 in grey, RGB, RGBA
and palette, and at bit depth 16 in RGB and RGBA, and returns what
``np.asarray(PIL.Image.open(path))`` returns for them: uint8 [H, W] for
grey, [H, W, 3] or [H, W, 4] for RGB(A), and for 16-bit files the high
byte of each sample (PIL opens them as 8-bit RGB(A)); a palette file gives
its [H, W] indices, as PIL's mode ``P`` does. Anything else raises an error
that names the file's mode.

The five row filters are undone on the whole image at once along its
anti-diagonals: a byte depends only on its left, upper and upper-left
neighbours, which lie on the two diagonals before its own, so each of the
H + W - 1 diagonals is one vectorised step.

The writer takes uint8 grey, RGB and RGBA, with the filter type of each
row chosen by the caller (0 by default).
"""
from __future__ import annotations

import struct
import zlib
from typing import Iterable, Optional, Tuple, Union

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (name, samples per pixel)
_COLOR_TYPES = {0: ("grey", 1), 2: ("RGB", 3), 3: ("palette", 1),
                4: ("grey+alpha", 2), 6: ("RGBA", 4)}
_SUPPORTED = {(0, 8), (2, 8), (3, 8), (6, 8), (2, 16), (6, 16)}


def _chunks(data: bytes, name: str):
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        typ = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(typ + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: CRC mismatch in chunk {typ!r}")
        yield typ, body
        if typ == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{name}: truncated PNG (no IEND)")


def _header(body: bytes) -> Tuple[int, int, int, int, int]:
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
    return w, h, depth, ctype, interlace


def png_size(path) -> Tuple[int, int]:
    """(width, height) from the file's IHDR chunk, reading 24 bytes."""
    with open(path, "rb") as f:
        head = f.read(24)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return struct.unpack(">II", head[16:24])


def png_is_palette(path) -> bool:
    """Whether the file is a palette PNG (colour type 3), from its IHDR
    chunk, reading 26 bytes."""
    with open(path, "rb") as f:
        head = f.read(26)
    if not head.startswith(_SIGNATURE) or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    return head[25] == 3


def _unfilter(raw: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the row filters: raw [H, 1 + W * bpp] -> bytes [H, W * bpp]."""
    H = raw.shape[0]
    ftype = raw[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"unknown PNG row filter {int(ftype.max())}")
    data = raw[:, 1:]
    if not ftype.any():
        return data.copy()
    W = data.shape[1] // bpp
    px = data.reshape(H, W, bpp).astype(np.int16)
    rows = np.arange(H)[:, None]
    # skewed layout: pixel (r, x) lies on diagonal d = r + x, held at
    # S[r + 1, d + 2]; row 0 and the columns left of each row stay 0, which
    # is what the filters read beyond the image's top and left edges
    D = H + W - 1
    S = np.zeros((H + 1, D + 2, bpp), np.int16)
    R = np.zeros((H, D, bpp), np.int16)
    R[rows, np.arange(W)[None, :] + rows] = px
    f = ftype.astype(np.int16)[:, None]
    for d in range(D):
        lo, hi = max(0, d - W + 1), min(H, d + 1)
        a = S[lo + 1:hi + 1, d + 1]        # left
        b = S[lo:hi, d + 1]                # up
        c = S[lo:hi, d]                    # up-left
        fd = f[lo:hi]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(fd == 1, a, np.where(fd == 2, b, np.where(
            fd == 3, (a + b) >> 1, np.where(fd == 4, paeth, 0))))
        S[lo + 1:hi + 1, d + 2] = (R[lo:hi, d] + pred) & 0xFF
    out = S[rows + 1, np.arange(W)[None, :] + rows + 2]
    return out.astype(np.uint8).reshape(H, W * bpp)


def decode_png(data: bytes, name: str = "PNG") -> np.ndarray:
    """The image of PNG bytes ``data`` (see the module docstring)."""
    header, idat = None, []
    for typ, body in _chunks(data, name):
        if typ == b"IHDR":
            header = _header(body)
        elif typ == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, interlace = header
    if ctype not in _COLOR_TYPES:
        raise ValueError(f"{name}: unknown PNG colour type {ctype}")
    mode, spp = _COLOR_TYPES[ctype]
    if (ctype, depth) not in _SUPPORTED:
        raise ValueError(f"{name}: {mode} PNG at bit depth {depth} is not "
                         f"supported (8-bit grey, RGB, RGBA, palette; 16-bit "
                         f"RGB, RGBA)")
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) {mode} PNG is not "
                         f"supported")
    bpp = spp * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{name}: {raw.size} bytes of image data, expected "
                         f"{h * (1 + w * bpp)}")
    img = _unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        img = img.reshape(h, w, spp, 2)[..., 0]      # big-endian high byte
    return img.reshape(h, w, spp) if spp > 1 else img.reshape(h, w)


def read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def _filter_rows(data: np.ndarray, bpp: int, filters: np.ndarray):
    """Apply the row filters: bytes [H, W * bpp] -> [H, 1 + W * bpp]."""
    x = data.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    f = filters[:, None]
    pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
        f == 3, (a + b) >> 1, np.where(f == 4, paeth, 0))))
    out = ((x - pred) & 0xFF).astype(np.uint8)
    return np.concatenate([filters.astype(np.uint8)[:, None], out], 1)


def encode_png(img: np.ndarray,
               filters: Optional[Union[int, Iterable[int]]] = None) -> bytes:
    """PNG bytes of uint8 [H, W] (grey), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA). ``filters``: the filter type of every row (an int), or a
    sequence that row r takes entry r mod its length of; None writes
    filter 0 (none) throughout."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG writes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, spp = img.shape
    ctype = {1: 0, 3: 2, 4: 6}.get(spp)
    if ctype is None:
        raise ValueError(f"PNG writes grey, RGB or RGBA, not {spp} channels")
    return _png_bytes(np.ascontiguousarray(img).reshape(h, -1), w, 8, ctype,
                      spp, filters)


def _png_bytes(data: np.ndarray, w: int, depth: int, ctype: int, spp: int,
               filters) -> bytes:
    """A PNG of the unfiltered bytes ``data`` [H, W * bytes per pixel]."""
    h = data.shape[0]
    if filters is None:
        filters = 0
    if isinstance(filters, int):
        ftype = np.full(h, filters, np.int16)
    else:
        seq = np.asarray(list(filters), np.int16)
        ftype = seq[np.arange(h) % len(seq)]
    raw = _filter_rows(data, spp * depth // 8, ftype)

    def chunk(typ: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + typ + body
                + struct.pack(">I", zlib.crc32(typ + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path, img: np.ndarray, filters=None) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img, filters))
