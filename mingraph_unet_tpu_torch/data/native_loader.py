"""ctypes binding of the C++ image decoders and batch loader
(``csrc/decode.cc``). Counterpart of ``mingraph_unet_tpu/data/native_loader.py``,
and the port's replacement for ``cv2.imread``.

- :func:`decode` reads a PNG, JPEG or BMP file as ``cv2.imread`` does (RGB
  or grey, the EXIF orientation applied), bit for bit; a file it cannot
  decode raises :class:`DecodeError` naming the cause (arithmetic coding,
  12-bit samples, CMYK, truncated data, ...): a ``ValueError`` that is
  also the ``FileNotFoundError`` the JAX package raises where
  ``cv2.imread`` gives nothing, as a missing file does.
- :func:`load_batch` decodes and resizes a batch on a thread pool. With
  ``exact=False`` it keeps the JAX loader's contract: PNG only, its own
  bilinear and integer-nearest resizes, and ``None`` for a batch with a
  file it does not take (the JAX package then reads the batch with OpenCV,
  and the port with :func:`decode`). With ``exact=True`` it reads every
  format :func:`decode` reads and resizes as ``cv2.resize`` (INTER_LINEAR,
  INTER_NEAREST) does; a batch with a file that fails gives ``None`` too.
- :func:`load_image` / :func:`load_mask`: one file under the JAX loader's
  contract.

The library is compiled at its first use by ``ops/kernels/build.py::
host_library``; one that cannot be built or loaded raises ``RuntimeError``
(with the compiler's first error line).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from mingraph_unet_tpu_torch.ops.kernels import build

__all__ = ["DecodeError", "ERRORS", "available", "decode", "load_batch", "load_image", "load_mask"]

# csrc/decode.cc's error codes.
ERRORS = {
    1: "cannot open the file",
    2: "not a PNG, JPEG or BMP file",
    3: "truncated data",
    4: "corrupt data",
    5: "arithmetic-coded JPEG, which is not supported",
    6: "JPEG with other than 8-bit samples, which is not supported",
    7: "lossless JPEG, which is not supported",
    8: "CMYK, YCCK or RGB-coded JPEG, which is not supported",
    9: "a coding feature that is not supported",
}


class DecodeError(FileNotFoundError, ValueError):
    """A file that cannot be read or decoded, with the cause."""


def _lib() -> ctypes.CDLL:
    try:
        return build.host_library("decode")
    except RuntimeError as e:
        raise RuntimeError(f"the native image decoder is unavailable ({e}); with use_native=False MangoDataset "
                           "still needs it, one file at a time") from e


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        build.host_library("decode")
    except RuntimeError:
        return False
    return True


def _ptr(arr: Optional[np.ndarray]) -> Optional[int]:
    return None if arr is None else arr.ctypes.data


def decode(path: str, gray: bool = False) -> np.ndarray:
    """``path`` decoded as ``cv2.imread`` decodes it: RGB uint8 (H, W, 3), or
    (H, W) with ``gray``."""
    lib = _lib()
    shape = (ctypes.c_int * 3)()
    buf = ctypes.c_void_p()
    rc = lib.mgu_decode(path.encode(), int(gray), ctypes.addressof(shape), ctypes.addressof(buf))
    if rc != 0:
        raise DecodeError(f"cannot decode {path}: {ERRORS.get(rc, f'error {rc}')}")
    try:
        h, w, c = shape
        out = np.ctypeslib.as_array(ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), (h * w * c,)).copy()
    finally:
        lib.mgu_free(buf)
    return out.reshape((h, w) if gray else (h, w, 3))


def load_image(path: str, size: Tuple[int, int]) -> Optional[np.ndarray]:
    """RGB uint8 (H, W, 3) at ``size`` (the JAX loader's bilinear when the
    file's size differs), or None when the file is not a PNG it decodes."""
    out = np.empty((*size, 3), np.uint8)
    return out if _lib().mgu_load_image(path.encode(), size[0], size[1], _ptr(out)) == 0 else None


def load_mask(path: str, size: Tuple[int, int]) -> Optional[np.ndarray]:
    """Gray uint8 (H, W) at ``size`` (nearest), or None when the file is not
    a PNG it decodes."""
    out = np.empty(size, np.uint8)
    return out if _lib().mgu_load_mask(path.encode(), size[0], size[1], _ptr(out)) == 0 else None


def load_batch(image_paths: List[str], mask_paths: Optional[List[str]], size: Tuple[int, int], threads: int = 4,
               exact: bool = False) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
    """Decode and resize a batch on ``threads`` threads: images (N, H, W, 3)
    and masks (N, H, W) uint8 (None without ``mask_paths``), or None when
    any file fails. ``exact`` picks OpenCV's decoding and resizing over the
    JAX loader's (module docstring)."""
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
                                  _ptr(imgs), _ptr(masks), threads, int(exact))
    return None if failures else (imgs, masks)
