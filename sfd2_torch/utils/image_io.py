"""Image files on the host: one reader and one PNG writer for the port.

The JAX package reads and writes images with OpenCV in some modules and
PIL in others (``training/flow_pairs.py``, ``training/datasets_aachen.py``,
``cli/segment_images.py``). Here both sit behind `read_image` and
`write_png`, which use OpenCV where it is installed and PIL otherwise,
each imported when first needed, and return arrays in RGB(A) channel
order whichever library decoded them. With neither installed a read or a
write raises an ``ImportError`` that names the file.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def _library():
    """("cv2", module) or ("pil", PIL.Image), OpenCV first; None if neither."""
    try:
        import cv2

        return "cv2", cv2
    except ImportError:
        pass
    try:
        from PIL import Image

        return "pil", Image
    except ImportError:
        return None


def _need_library(path, what: str):
    lib = _library()
    if lib is None:
        raise ImportError(f"{what} {path}: needs OpenCV (cv2) or PIL, and neither is installed")
    return lib


def read_image(path, unchanged: bool = False) -> np.ndarray:
    """The image at `path` as uint8. By default [H, W, 3] RGB (a gray image
    repeated, an alpha channel dropped: ``cv2.imread``'s colour read);
    with `unchanged` the channels as stored: [H, W] gray, [H, W, 3] RGB or
    [H, W, 4] RGBA. A missing or undecodable file raises
    ``FileNotFoundError``."""
    path = Path(path)
    kind, lib = _need_library(path, "reading")
    if not path.is_file():
        raise FileNotFoundError(path)
    if kind == "cv2":
        img = lib.imread(str(path), lib.IMREAD_UNCHANGED if unchanged else lib.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 3:  # BGR(A) → RGB(A)
            img = img[..., [2, 1, 0, 3][: img.shape[2]]]
        return np.ascontiguousarray(img)
    with lib.open(path) as im:
        if not unchanged:
            im = im.convert("RGB")
        return np.asarray(im).copy()


def read_rgb(path) -> np.ndarray:
    """float32 [H, W, 3] RGB in [0, 1] (the datasets' ``_load_rgb``)."""
    return read_image(path).astype(np.float32) / 255.0


def write_png(path, array: np.ndarray):
    """Write uint8 [H, W] gray, [H, W, 3] RGB or [H, W, 4] RGBA as a PNG."""
    path = Path(path)
    kind, lib = _need_library(path, "writing")
    array = np.ascontiguousarray(array)
    if array.dtype != np.uint8 or array.ndim not in (2, 3) or \
            (array.ndim == 3 and array.shape[2] not in (3, 4)):
        raise ValueError(f"write_png {path}: need uint8 [H, W(, 3|4)], got "
                         f"{array.dtype} {array.shape}")
    if kind == "cv2":
        if array.ndim == 3:  # RGB(A) → BGR(A)
            array = np.ascontiguousarray(array[..., [2, 1, 0, 3][: array.shape[2]]])
        if not lib.imwrite(str(path), array):
            raise OSError(f"write_png: could not write {path}")
    else:
        lib.fromarray(array).save(path, format="PNG")
