"""The port's native data runtime (matryodshka_tpu_torch/data/native.py,
its own build of runtime/matryio.cc) against the PIL path and against the
JAX package's binding (matryodshka_tpu/data/native.py) on the same JPEG:
tests/test_native_runtime.py's checks on the port's copy, the two
bindings' decodes bit for bit, and data/images.load_and_resize taking the
native path for JPEGs, PIL otherwise. Skips where g++ or libjpeg is
absent, as the JAX test does.
"""

import os

import numpy as np
import pytest

from matryodshka_tpu.data import native as jnative
from matryodshka_tpu_torch.data import images as img_lib
from matryodshka_tpu_torch.data import native
from matryodshka_tpu_torch.data.synthetic import erp_texture


@pytest.fixture(scope="module")
def jpeg_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    path = os.path.join(str(d), "img.jpeg")
    img_lib.write_image(path, erp_texture(96, 192, seed=3))
    return path


@pytest.fixture(scope="module")
def built():
    if not native.native_available():
        pytest.skip("libmatryio not built (no g++/libjpeg)")
    assert native.library_path().exists()


def test_native_builds_and_loads(jpeg_file, built):
    out = native.decode_resize(jpeg_file, 48, 96)
    assert out.shape == (48, 96, 3) and out.dtype == np.float32
    assert 0.0 <= out.min() and out.max() <= 1.0


def test_native_matches_pil(jpeg_file, built):
    """Within PIL's uint8 quantum, as tests/test_native_runtime.py."""
    nat = native.decode_resize(jpeg_file, 48, 96, fast=False)
    pil = img_lib.load_and_resize(jpeg_file, 48, 96, prefer_native=False)
    assert np.abs(nat - pil).max() < 0.01
    assert np.abs(nat - pil).mean() < 1.0 / 255.0


def test_native_identity_size(jpeg_file, built):
    nat = native.decode_resize(jpeg_file, 96, 192, fast=False)
    pil = img_lib.load_and_resize(jpeg_file, 96, 192, prefer_native=False)
    np.testing.assert_allclose(nat, pil, atol=0.005)


def test_native_batch(jpeg_file, built):
    out = native.load_batch([jpeg_file] * 5, 32, 64, n_threads=4)
    assert out.shape == (5, 32, 64, 3)
    for i in range(1, 5):
        np.testing.assert_array_equal(out[0], out[i])


def test_native_missing_file_raises(built):
    with pytest.raises(IOError):
        native.decode_resize("/nonexistent/nope.jpeg", 8, 8)


def test_native_fast_scale_close(jpeg_file, built):
    fast = native.decode_resize(jpeg_file, 24, 48, fast=True)
    exact = native.decode_resize(jpeg_file, 24, 48, fast=False)
    assert np.abs(fast - exact).mean() < 0.02


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("size", [(24, 48), (48, 96), (96, 192)])
def test_native_matches_jax_binding(jpeg_file, built, fast, size):
    """The two bindings of one source on one JPEG: the same floats."""
    if not jnative.native_available():
        pytest.skip("the JAX package's libmatryio is not built")
    np.testing.assert_array_equal(
        native.decode_resize(jpeg_file, *size, fast=fast),
        jnative.decode_resize(jpeg_file, *size, fast=fast))
    np.testing.assert_array_equal(
        native.load_batch([jpeg_file] * 2, *size),
        jnative.load_batch([jpeg_file] * 2, *size))


def test_load_and_resize_prefers_native(jpeg_file, built, tmp_path,
                                        monkeypatch):
    """JPEGs decode natively (the JAX load_and_resize's choice), a PNG
    through PIL, and without the library the PIL fallback."""
    np.testing.assert_array_equal(img_lib.load_and_resize(jpeg_file, 48, 96),
                                  native.decode_resize(jpeg_file, 48, 96))
    png = str(tmp_path / "img.png")
    img_lib.write_image(png, erp_texture(24, 48, seed=4))
    from PIL import Image
    with Image.open(png) as im:
        want = np.asarray(im.convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(img_lib.load_and_resize(png, 24, 48), want)
    monkeypatch.setattr(native, "native_available", lambda: False)
    np.testing.assert_array_equal(
        img_lib.load_and_resize(jpeg_file, 48, 96),
        img_lib.load_and_resize(jpeg_file, 48, 96, prefer_native=False))
