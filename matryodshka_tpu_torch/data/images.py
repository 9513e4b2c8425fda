"""Image IO: decode + area resize, and PNG writing.

Copy of `matryodshka_tpu/data/images.py`: JPEGs decode through the native
runtime (data/native.py) where it builds, as in the JAX package, else
through PIL, whose BOX filter computes the fractional box average of the
reference's tf.image.resize_area (datasets.py:507-519). PIL is imported
inside the functions that need it, so the package imports where PIL is
not installed.
"""

from __future__ import annotations

import os

import numpy as np


def load_and_resize(path: str, height: int, width: int,
                    prefer_native: bool = True) -> np.ndarray:
    """Decode an image file and area-resize to (height, width).

    JPEGs go through the native runtime (data/native.py) when it is
    available, else, and for other files or a file it cannot decode,
    through PIL. Returns float32 [H, W, 3] in [0, 1]."""
    if prefer_native and path.lower().endswith((".jpg", ".jpeg")):
        from matryodshka_tpu_torch.data import native
        if native.native_available():
            try:
                return native.decode_resize(path, height, width)
            except IOError:
                pass  # PIL for odd files, as the JAX package does
    from PIL import Image
    with Image.open(path) as im:
        im = im.convert("RGB")
        if im.size != (width, height):
            im = im.resize((width, height), Image.BOX)
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return arr


def write_image(path: str, image: np.ndarray) -> None:
    """Save an image; accepts float [0,1] / [0,255] or uint8
    (matryodshka/utils.py:76-81 equivalent)."""
    from PIL import Image
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        if arr.max() <= 1.0 + 1e-6:
            arr = arr * 255.0
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(arr).save(path)


def ods_image_path(image_dir: str, scene_id: str, image_id: str) -> str:
    """{scene_id}_pos{image_id}.jpeg (datasets.py:539)."""
    return os.path.join(image_dir, f"{scene_id}_pos{image_id}.jpeg")


def realestate_image_path(image_dir: str, seq_id: str,
                          timestamp: str) -> str:
    """{id}/{id}_{timestamp}.jpg (datasets.py:405-406)."""
    return os.path.join(image_dir, seq_id, f"{seq_id}_{timestamp}.jpg")
