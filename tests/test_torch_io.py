"""The port's host-side I/O and metrics against the JAX package and the
libraries it uses (PIL, cv2, scipy), on the CPU: PSNR, SSIM and normal MAE
to 1e-10, the JET table equal to cv2's in all 256 entries, the bicubic
resize within 1 level of cv2.resize, the PNG reader equal to PIL on every
mode and row filter it accepts (and its refusals), the PNG writer
round-tripping through PIL, the RGBE reader equal to JAX's on flat, RLE
and +Y files, the image loaders equal to JAX's, and LPIPS None without
weights."""
import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from tensoir_tpu.data import hdr as JH
from tensoir_tpu.data import images as JI
from tensoir_tpu.utils import metrics as JM

from tensoir_tpu_torch.data import hdr as TH
from tensoir_tpu_torch.data import images as TI
from tensoir_tpu_torch.ops.resize import resize_cubic_u8
from tensoir_tpu_torch.utils import metrics as TM
from tensoir_tpu_torch.utils import png
from tensoir_tpu_torch.utils.video import write_videos

RNG = np.random.default_rng(0)


def _images(shape, n=2):
    """Random images in [0, 1] with a smooth half (so that a filter other
    than None wins PIL's adaptive choice on some rows)."""
    out = []
    for _ in range(n):
        x = RNG.random(shape)
        x[: shape[0] // 2] = np.linspace(0, 1, shape[1])[None, :, None]
        out.append(x)
    return out


# ---------------------------------------------------------------- metrics


def test_psnr_ssim_mae_match_jax():
    a, b = _images((23, 31, 3))
    assert abs(TM.psnr(a, b) - JM.psnr(a, b)) <= 1e-10
    assert TM.mse2psnr(0.0) == JM.mse2psnr(0.0) == float("inf")
    assert abs(TM.rgb_ssim(a, b) - JM.rgb_ssim(a, b)) <= 1e-10
    np.testing.assert_allclose(TM.rgb_ssim(a, b, return_map=True),
                               JM.rgb_ssim(a, b, return_map=True),
                               rtol=0, atol=1e-10)
    n1 = RNG.normal(size=(50, 3))
    n2 = n1 + 0.1 * RNG.normal(size=(50, 3))
    n1 /= np.linalg.norm(n1, axis=-1, keepdims=True)
    n2 /= np.linalg.norm(n2, axis=-1, keepdims=True)
    assert abs(TM.normal_mae_deg(n1, n2) - JM.normal_mae_deg(n1, n2)) <= 1e-10


def test_jet_equals_cv2_and_visualize_depth_matches_jax():
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    cv_lut = cv2.cvtColor(cv2.applyColorMap(levels, cv2.COLORMAP_JET),
                          cv2.COLOR_BGR2RGB).reshape(256, 3)
    assert np.array_equal(TM.JET, cv_lut)
    depth = RNG.uniform(1.0, 7.0, size=(20, 30)).astype(np.float32)
    depth[0, :5] = 0.0
    depth[1, 1] = np.nan
    for minmax in (None, [2.0, 6.0]):
        got = TM.visualize_depth(depth, minmax)
        assert got.dtype == np.uint8
        assert np.array_equal(got, JM.visualize_depth(depth, minmax))


def test_lpips_is_none_without_weights_and_refuses_with_them(tmp_path,
                                                             monkeypatch):
    img = RNG.random((8, 8, 3))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TENSOIR_LPIPS_WEIGHTS", raising=False)
    assert TM.rgb_lpips(img, img, "alex") is None
    assert JM.rgb_lpips(img, img, "alex") is None
    np.savez(tmp_path / "w.npz", net=np.array("vgg"))
    monkeypatch.setenv("TENSOIR_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    assert TM.rgb_lpips(img, img, "alex") is None     # another net's file
    # the net's own file is used (tests/test_torch_lpips.py computes with
    # one): on the card unless the caller asks for the CPU, and a file that
    # lacks the network's weights is refused by the name of the first
    monkeypatch.setattr(TM, "_LPIPS_PARAMS", {})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TM.rgb_lpips(img, img, "vgg")
    with pytest.raises(KeyError, match="conv0_w"):
        TM.rgb_lpips(img, img, "vgg", device="cpu")


@pytest.mark.parametrize("src,dsize", [((1024, 2048, 3), (512, 256)),
                                       ((16, 32, 3), (512, 256)),
                                       ((37, 53), (20, 11))],
                         ids=["probe_down", "probe_up", "odd_grey"])
def test_bicubic_resize_within_one_level_of_cv2(src, dsize):
    img = (RNG.random(src) * 255).astype(np.uint8)
    img[: src[0] // 2] = np.linspace(0, 255, src[1]).astype(np.uint8)[
        (None, slice(None)) + (None,) * (len(src) - 2)]
    got = resize_cubic_u8(img, dsize)
    want = cv2.resize(img, dsize, interpolation=cv2.INTER_CUBIC)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# -------------------------------------------------------------------- PNG


def _pil_bytes(arr, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", **kw)
    return buf.getvalue()


def _pil_array(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _row_filters(data):
    """The filter type of each row of a non-interlaced 8-bit PNG."""
    w, h, depth, ctype = struct.unpack(">IIBB", data[16:26])
    spp = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    idat, pos = b"", 8
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("mode,shape", [("L", (33, 27)), ("RGB", (33, 27, 3)),
                                        ("RGBA", (33, 27, 4))])
def test_png_reader_equals_pil_on_files_pil_writes(mode, shape):
    filters = set()
    for x in _images(shape[:2] + (1,) if mode == "L" else shape):
        arr = (x * 255).astype(np.uint8).reshape(shape)
        for kw in ({}, {"optimize": True}, {"compress_level": 1}):
            data = _pil_bytes(arr, mode, **kw)
            filters |= _row_filters(data)
            got = png.decode_png(data)
            assert got.dtype == np.uint8
            assert np.array_equal(got, _pil_array(data))
    assert len(filters) >= 2, filters    # PIL's adaptive filter choice


def test_png_reader_equals_pil_on_palette_files():
    """8-bit palettes read as PIL's indices; PIL writes palettes of up to
    16 colours at 4 bits or fewer, which the reader refuses."""
    grey = (RNG.random((21, 30)) * 255).astype(np.uint8)
    for colors in (256, 17):
        im = Image.fromarray(grey, "L").convert("RGB").quantize(colors)
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        got = png.decode_png(buf.getvalue())
        assert np.array_equal(got, _pil_array(buf.getvalue()))   # indices
    buf = io.BytesIO()
    Image.fromarray(grey, "L").convert("RGB").quantize(7).save(buf, "PNG")
    with pytest.raises(ValueError, match="palette PNG at bit depth 4"):
        png.decode_png(buf.getvalue())


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "avg", "paeth", "cycle"])
@pytest.mark.parametrize("kind", ["L", "RGB", "RGBA", "RGB16", "RGBA16"])
def test_png_every_row_filter_reads_as_pil_reads_it(kind, filters):
    """Files written with each row filter, at 8 bits in grey, RGB and RGBA
    and at 16 bits in RGB and RGBA: the reader returns what PIL does (for
    16 bits, PIL's 8-bit RGB(A) of the high bytes), and 8-bit files
    round-trip."""
    spp = {"L": 1, "RGB": 3, "RGBA": 4, "RGB16": 3, "RGBA16": 4}[kind]
    hi = 65535 if kind.endswith("16") else 255
    img = (_images((19, 23, spp), 1)[0] * hi).astype(
        np.uint16 if hi > 255 else np.uint8)
    if spp == 1:
        img = img[..., 0]
    if hi == 255:
        data = png.encode_png(img, filters)
    else:   # big-endian samples through the writer's own filters
        data = png._png_bytes(img.astype(">u2").view(np.uint8).reshape(
            19, -1), 23, 16, {3: 2, 4: 6}[spp], spp, filters)
    want = _pil_array(data)
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    if hi == 255:
        assert np.array_equal(got, img)
    else:
        assert np.array_equal(got, (img >> 8).astype(np.uint8))


def test_png_size_and_file_round_trip(tmp_path):
    img = (RNG.random((12, 17, 4)) * 255).astype(np.uint8)
    path = tmp_path / "x.png"
    png.write_png(path, img, (0, 1, 2, 3, 4))
    assert png.png_size(path) == Image.open(path).size == (17, 12)
    assert np.array_equal(png.read_png(path), img)


def _with_ihdr(data, **fields):
    """``data`` with IHDR fields replaced and its CRC fixed."""
    w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB",
                                                          data[16:29])
    vals = dict(w=w, h=h, depth=depth, ctype=ctype, inter=inter)
    vals.update(fields)
    body = struct.pack(">IIBBBBB", vals["w"], vals["h"], vals["depth"],
                       vals["ctype"], comp, filt, vals["inter"])
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body) & 0xFFFFFFFF)
    return data[:16] + body + crc + data[33:]


def test_png_refusals_name_the_mode():
    grey16 = _pil_bytes(np.full((4, 4), 1000, np.uint16), "I;16")
    with pytest.raises(ValueError, match="grey PNG at bit depth 16"):
        png.decode_png(grey16)
    with pytest.raises(ValueError, match="grey\\+alpha PNG at bit depth 8"):
        png.decode_png(_pil_bytes(np.zeros((4, 4, 2), np.uint8), "LA"))
    buf = io.BytesIO()
    Image.new("1", (4, 4)).save(buf, format="PNG")
    with pytest.raises(ValueError, match="grey PNG at bit depth 1"):
        png.decode_png(buf.getvalue())
    rgb = png.encode_png(np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="interlaced \\(Adam7\\) RGB PNG"):
        png.decode_png(_with_ihdr(rgb, inter=1))
    with pytest.raises(ValueError, match="CRC"):
        png.decode_png(rgb[:-5] + b"\x00" + rgb[-4:])
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")
    with pytest.raises(ValueError, match="2 channels"):
        png.encode_png(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(np.zeros((4, 4, 3), np.uint16))


# ---------------------------------------------------------------- RGBE


def _hdr_files(tmp_path):
    img = (RNG.random((6, 40, 3)) * 4).astype(np.float32)
    img[:, :20] = 0.5                      # runs for the RLE encoder
    flat = str(tmp_path / "flat.hdr")
    JH.write_hdr(flat, img)
    rle = str(tmp_path / "rle.hdr")
    cv2.imwrite(rle, img[..., ::-1].copy())          # new-style RLE
    raw = open(flat, "rb").read()
    head, _, body = raw.partition(b"-Y 6 +X 40\n")
    up = str(tmp_path / "up.hdr")
    with open(up, "wb") as fh:
        fh.write(head + b"+Y 6 +X 40\n"
                 + np.frombuffer(body, np.uint8).reshape(6, 40, 4)[::-1]
                 .tobytes())
    return img, {"flat": flat, "rle": rle, "up": up}


def test_read_hdr_matches_jax_on_flat_rle_and_plus_y(tmp_path):
    img, files = _hdr_files(tmp_path)
    assert open(files["rle"], "rb").read().split(b"+X 40\n", 1)[1][:2] \
        == b"\x02\x02"
    for name, path in files.items():
        got, want = TH.read_hdr(path), JH.read_hdr(path)
        assert got.dtype == np.float32 and np.array_equal(got, want), name
    np.testing.assert_array_equal(TH.read_hdr(files["up"]),
                                  TH.read_hdr(files["flat"]))
    # the writer is JAX's, byte for byte
    TH.write_hdr(str(tmp_path / "port.hdr"), img)
    assert open(tmp_path / "port.hdr", "rb").read() == \
        open(files["flat"], "rb").read()


def test_read_hdr_refuses_what_jax_reads_through_imageio(tmp_path):
    _, files = _hdr_files(tmp_path)
    raw = open(files["flat"], "rb").read().replace(b"-Y 6 +X 40",
                                                   b"+X 40 -Y 6")
    xmajor = tmp_path / "xmajor.hdr"
    xmajor.write_bytes(raw)
    with pytest.raises(ValueError, match="X-major"):
        TH.read_hdr(str(xmajor))
    nosig = tmp_path / "nosig.hdr"
    nosig.write_bytes(b"P6\n" + raw)
    with pytest.raises(ValueError, match="signature"):
        TH.read_hdr(str(nosig))


# -------------------------------------------------------------- loaders


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "L", "P"])
def test_image_loaders_match_jax(tmp_path, mode):
    arr = (RNG.random((9, 11, 4)) * 255).astype(np.uint8)
    arr[..., 3] = (arr[..., 3] > 64) * 255
    arr[0, 0, 3] = 128
    im = Image.fromarray(arr, "RGBA")
    im = im if mode == "RGBA" else (im.convert("RGB").quantize(64)
                                    if mode == "P" else im.convert(mode))
    path = tmp_path / f"x_{mode}.png"
    im.save(path)
    for wh in ((11, 9), None):
        got, gmask = TI.load_rgba_white_composite(path, wh)
        want, wmask = JI.load_rgba_white_composite(path, wh)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert np.array_equal(gmask, wmask)
    if mode in ("RGBA", "RGB"):
        got = TI.load_normal_png(path, (11, 9))
        want = JI.load_normal_png(path, (11, 9))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_image_loaders_refuse_a_resize_and_save_png_matches_jax(tmp_path):
    """The loaders resize a file of another size on load, as JAX's do
    with PIL (once refused here; tests/test_torch_helpers.py holds the
    resize at more sizes and modes); and save_png writes JAX's PNG."""
    path = tmp_path / "x.png"
    Image.fromarray((RNG.random((8, 8, 4)) * 255).astype(np.uint8)).save(path)
    for wh in ((4, 4), (5, 3)):
        got, gmask = TI.load_rgba_white_composite(path, wh)
        want, wmask = JI.load_rgba_white_composite(path, wh)
        assert np.array_equal(got, want) and np.array_equal(gmask, wmask)
        assert np.array_equal(TI.load_normal_png(path, wh),
                              JI.load_normal_png(path, wh))
    img = RNG.random((5, 7, 3)).astype(np.float32)
    TI.save_png(tmp_path / "port.png", img)
    JI.save_png(tmp_path / "jax.png", img)
    assert np.array_equal(png.read_png(tmp_path / "port.png"),
                          np.asarray(Image.open(tmp_path / "jax.png")))


def test_write_videos_writes_no_video_and_says_so(tmp_path, capsys):
    write_videos(str(tmp_path / "v"), [("rgb", 3), ("empty", 0)], tag="eval")
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and "rgb (3 frames)" in out
    assert "empty" not in out and not os.path.exists(tmp_path / "v")
    write_videos(str(tmp_path / "v"), [("rgb", 0)])
    assert capsys.readouterr().out == ""
