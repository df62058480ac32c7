"""PNG codec (utils/image.py): round trips, and agreement with Pillow where
Pillow is installed (it is not needed by the program)."""

import numpy as np
import pytest

from pathtracer.utils.image import encode_png, load_image, load_png, save_png


def _img(h=37, w=53, seed=0):
    rs = np.random.RandomState(seed)
    img = (rs.rand(h, w, 3) * 255).astype(np.uint8)
    img[h // 3: h // 2] = 7                      # flat band: filters differ
    return img


def test_png_roundtrip(tmp_path):
    img = _img()
    save_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(load_png(tmp_path / "a.png"), img)
    f = load_image(str(tmp_path / "a.png"))
    assert f.dtype == np.float32 and f.shape == img.shape
    np.testing.assert_allclose(f, img / 255.0, atol=1e-7)


def test_png_encoder_levels_decode_alike(tmp_path):
    img = _img(64, 48, seed=3)
    for level in (1, 9):
        (tmp_path / f"l{level}.png").write_bytes(encode_png(img, level=level))
        np.testing.assert_array_equal(load_png(tmp_path / f"l{level}.png"), img)


def test_png_rejects_non_png(tmp_path):
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError):
        load_png(tmp_path / "x.png")


def test_png_encoder_shape_check():
    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "I;16"])
def test_png_decoder_matches_pillow(tmp_path, mode):
    """Pillow writes with its adaptive scanline filters (Sub/Up/Average/
    Paeth); the decoder must reproduce Pillow's own decode."""
    Image = pytest.importorskip("PIL.Image")
    src = Image.fromarray(_img(41, 67, seed=5))
    im = src.convert("L").convert("I;16") if mode == "I;16" else src.convert(mode)
    path = tmp_path / f"{mode.replace(';', '')}.png"
    im.save(path, optimize=True)
    ours = load_png(path)
    if mode == "I;16":
        want = (np.asarray(Image.open(path)).astype(np.uint32) >> 8)[..., None]
    else:
        ref = Image.open(path)
        want = np.asarray(ref.convert("RGBA" if "A" in mode else "RGB"))
        if mode in ("L", "LA"):
            want = np.concatenate([want[..., :1], want[..., 3:]], -1)
    np.testing.assert_array_equal(ours, want.astype(np.uint8))


def test_png_encoder_read_by_pillow(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = _img(20, 30, seed=9)
    save_png(tmp_path / "p.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "p.png")), img)
