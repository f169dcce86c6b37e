"""ctypes binding of the C++ PNG decode and resize batch loader
(``csrc/decode.cc``). Counterpart of ``mingraph_unet_tpu/data/native_loader.py``.

The library is compiled at its first use by ``ops/kernels/build.py::
host_library`` into the package's ``build/`` directory. A library that
cannot be built or loaded raises ``RuntimeError`` (with the compiler's
first error line): nothing falls back to OpenCV quietly; a
``MangoDataset(use_native=False)`` decodes with OpenCV instead. A file the
library cannot decode (not a PNG, missing) gives ``None``, as in the JAX
package, and ``BatchLoader`` then takes the OpenCV path for that batch.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from mingraph_unet_tpu_torch.ops.kernels import build

__all__ = ["available", "load_batch", "load_image", "load_mask"]


def _lib() -> ctypes.CDLL:
    try:
        return build.host_library("decode")
    except RuntimeError as e:
        raise RuntimeError(f"the native PNG loader is unavailable ({e}); pass use_native=False to MangoDataset "
                           "to decode with OpenCV") from e


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        build.host_library("decode")
    except RuntimeError:
        return False
    return True


def _ptr(arr: Optional[np.ndarray]) -> Optional[int]:
    return None if arr is None else arr.ctypes.data


def load_image(path: str, size: Tuple[int, int]) -> Optional[np.ndarray]:
    """RGB uint8 (H, W, 3) at ``size`` (bilinear when the file's size
    differs), or None when the file cannot be decoded."""
    out = np.empty((*size, 3), np.uint8)
    return out if _lib().mgu_load_image(path.encode(), size[0], size[1], _ptr(out)) == 0 else None


def load_mask(path: str, size: Tuple[int, int]) -> Optional[np.ndarray]:
    """Gray uint8 (H, W) at ``size`` (nearest), or None when the file cannot
    be decoded."""
    out = np.empty(size, np.uint8)
    return out if _lib().mgu_load_mask(path.encode(), size[0], size[1], _ptr(out)) == 0 else None


def load_batch(image_paths: List[str], mask_paths: Optional[List[str]], size: Tuple[int, int], threads: int = 4
               ) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Decode and resize a batch on ``threads`` threads: images (N, H, W, 3)
    and masks (N, H, W) uint8 (None without ``mask_paths``), or None when
    any file fails."""
    lib = _lib()
    n = len(image_paths)
    if mask_paths is not None and len(mask_paths) != n:
        raise ValueError(f"{n} images but {len(mask_paths)} masks")
    h, w = size
    imgs = np.empty((n, h, w, 3), np.uint8)
    masks = np.empty((n, h, w), np.uint8) if mask_paths is not None else None
    c_imgs = (ctypes.c_char_p * n)(*[p.encode() for p in image_paths])
    c_masks = (ctypes.c_char_p * n)(*[p.encode() for p in mask_paths]) if mask_paths is not None else None
    failures = lib.mgu_load_batch(ctypes.addressof(c_imgs), ctypes.addressof(c_masks) if c_masks else None, n, h, w,
                                  _ptr(imgs), _ptr(masks), threads)
    return None if failures else (imgs, masks)
