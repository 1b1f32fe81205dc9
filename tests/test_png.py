"""numpy + zlib PNG codec (data/png.py): round trips, the native decoder
as the independent reference, and filtered rows from another encoder."""
import numpy as np
import pytest

from tracking_sdf_tpu.data import native, png


def _images(rng):
    depth = rng.integers(0, 65536, size=(37, 53), dtype=np.uint16)
    depth[rng.random(depth.shape) < 0.1] = 0  # TUM holes
    rgb = rng.integers(0, 256, size=(37, 53, 3), dtype=np.uint8)
    return {"depth16": depth, "rgb8": rgb}


@pytest.mark.parametrize("kind", ["depth16", "rgb8"])
def test_png_roundtrip_matches_native_decoder(kind, tmp_path):
    img = _images(np.random.default_rng(3))[kind]
    path = str(tmp_path / f"{kind}.png")
    png.write_png(path, img)
    back = png.read_png(path)
    assert back.dtype == img.dtype and back.shape == img.shape
    np.testing.assert_array_equal(back, img)
    if not native.available():
        pytest.skip("native loader toolchain unavailable")
    if kind == "depth16":
        ref = native.decode_depth(path)  # meters, NaN holes
        want = np.where(img == 0, np.nan, img.astype(np.float32) / 5000.0)
        np.testing.assert_array_equal(np.isnan(ref), np.isnan(want))
        ok = ~np.isnan(ref)
        np.testing.assert_array_equal(ref[ok], want[ok])
    else:
        ref = native.decode_rgb(path)  # [0, 1] float
        np.testing.assert_array_equal(ref, img.astype(np.float32) / 255.0)


def test_png_decodes_filtered_rows_from_another_encoder(tmp_path):
    """Other encoders pick per-row filters (sub/up/average/Paeth); the
    decoder must undo all of them."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(4)
    # smooth gradients make the encoder's adaptive filtering pick
    # non-trivial filters
    yy, xx = np.mgrid[0:40, 0:50]
    rgb = np.stack([(xx * 5) % 256, (yy * 6) % 256, (xx + yy) % 256],
                   axis=-1).astype(np.uint8)
    rgb[rng.random(rgb.shape[:2]) < 0.05] = 255
    path = str(tmp_path / "filtered.png")
    Image.fromarray(rgb).save(path, optimize=True)
    np.testing.assert_array_equal(png.read_png(path), rgb)
    depth = ((xx * 997 + yy * 331) % 65536).astype(np.uint16)
    dpath = str(tmp_path / "filtered16.png")
    Image.fromarray(depth).save(dpath)
    np.testing.assert_array_equal(png.read_png(dpath),
                                  np.asarray(Image.open(dpath)))


def _filter_row(ftype, line, prev, bpp):
    """Reference PNG filter (encoder side), byte by byte."""
    out = []
    for x, raw in enumerate(line):
        a = line[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out.append((raw - pred) % 256)
    return out


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_unfilter_each_filter_type(ftype):
    rng = np.random.default_rng(ftype)
    h, w, bpp = 5, 7, 3
    raw = rng.integers(0, 256, size=(h, w * bpp), dtype=np.uint8)
    rows, prev = [], [0] * (w * bpp)
    for y in range(h):
        line = [int(v) for v in raw[y]]
        rows.append([ftype] + _filter_row(ftype, line, prev, bpp))
        prev = line
    data = np.asarray(rows, np.uint8).ravel()
    np.testing.assert_array_equal(png._unfilter(data, h, w * bpp, bpp), raw)
