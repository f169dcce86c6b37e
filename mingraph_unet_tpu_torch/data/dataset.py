"""Dataset and input pipeline of the segmentation trainer. Counterpart of
``mingraph_unet_tpu/data/dataset.py``.

- Host side: :class:`MangoDataset` (sorted-glob image/mask pairing with a
  count check, zero masks when the mask directory is absent, decode and
  resize to uint8 HWC images and int32 masks, and with a COCO annotation
  file the uint8 instance masks) and :class:`BatchLoader` (the same
  numpy-seeded epoch order as the JAX loader, so both yield the same
  batches). No OpenCV: files are decoded by the C++ of
  ``data/native_loader.py`` (``cv2.imread``'s arrays, bit for bit) and
  resized by ``data/raster.py`` (``cv2.resize``'s), so every batch equals
  the JAX package's: a batch of PNGs without instances is decoded and
  resized as the JAX package's own C++ loader does it, every other batch
  (a JPEG in it, instances, or a PNG that loader does not take) as
  OpenCV does it.
- Device side: :func:`device_preprocess_batch`, the synced augmentation and
  normalization of a uint8 batch (and its instance masks) on the device it
  lies on.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mingraph_unet_tpu_torch.data import native_loader
from mingraph_unet_tpu_torch.data.annotations import CocoAnnotations
from mingraph_unet_tpu_torch.data.raster import resize_linear_u8, resize_nearest
from mingraph_unet_tpu_torch.ops.image import AugmentDraw, augment_image, augment_labels, augment_pair, normalize

__all__ = ["MangoDataset", "BatchLoader", "device_preprocess_batch", "load_image_rgb", "load_mask", "read_image"]


def load_image_rgb(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 HWC (``cv2.imread`` + BGR→RGB)."""
    return native_loader.decode(path)


def load_mask(path: str) -> np.ndarray:
    """Decode a label mask to uint8 HW (``cv2.imread(IMREAD_GRAYSCALE)``)."""
    return native_loader.decode(path, gray=True)


def _resize(img: np.ndarray, hw: Tuple[int, int], nearest: bool) -> np.ndarray:
    if img.shape[:2] == tuple(hw):
        return img
    return resize_nearest(img, hw) if nearest else resize_linear_u8(img, hw)


def read_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """An image file as RGB uint8 HWC, at ``size`` when it is given
    (``cv2.resize`` INTER_LINEAR, as the JAX package's inference resizes)."""
    img = load_image_rgb(path)
    return img if size is None else _resize(img, tuple(size), nearest=False)


class MangoDataset:
    """Paired (image, mask) dataset with the reference's pairing rules.
    ``strict=False`` substitutes zeros for an item that fails to load, and
    says so, where the default raises. With ``annotations_file`` (COCO,
    ``data/annotations.py``) an item also carries its ``max_instances``
    instance masks, and without a mask folder the semantic mask is their
    union. ``use_native`` lets :class:`BatchLoader` decode each batch on
    ``native_threads`` threads (``data/native_loader.py::load_batch``);
    without it the items are decoded one at a time, by the same
    decoders."""

    IMAGE_EXTS = ("*.png", "*.jpg", "*.jpeg")

    def __init__(
        self,
        image_dir: str,
        mask_dir: Optional[str] = None,
        image_size: Tuple[int, int] = (128, 128),
        num_classes: int = 2,
        strict: bool = True,
        use_native: bool = True,
        native_threads: int = 4,
        annotations_file: Optional[str] = None,
        max_instances: int = 16,
    ):
        self.image_dir = image_dir
        self.mask_dir = mask_dir
        self.image_size = tuple(image_size)
        self.num_classes = num_classes
        self.strict = strict
        self.use_native = use_native
        self.native_threads = native_threads
        self.max_instances = max_instances
        self.annotations = CocoAnnotations(annotations_file) if annotations_file else None
        self.image_paths: List[str] = sorted(
            p for ext in self.IMAGE_EXTS for p in glob.glob(os.path.join(image_dir, ext))
        )
        if not self.image_paths:
            raise FileNotFoundError(f"No images found in {image_dir!r}")
        self.mask_paths: Optional[List[str]] = None
        if mask_dir and os.path.isdir(mask_dir):
            masks = sorted(p for ext in self.IMAGE_EXTS for p in glob.glob(os.path.join(mask_dir, ext)))
            if masks:
                if len(masks) != len(self.image_paths):
                    raise ValueError(
                        f"Image/mask count mismatch: {len(self.image_paths)} images vs "
                        f"{len(masks)} masks ({image_dir!r} / {mask_dir!r})"
                    )
                self.mask_paths = masks
        if self.mask_paths is None:
            print(f"[MangoDataset] No masks for {image_dir!r}; using zero dummy masks.")

    def __len__(self) -> int:
        return len(self.image_paths)

    def _instances(self, idx: int) -> np.ndarray:
        image_id = self.annotations.id_for_file(self.image_paths[idx])
        if image_id is None:
            return np.zeros((self.max_instances, *self.image_size), np.uint8)
        return self.annotations.instance_masks_for(image_id, self.image_size, self.max_instances)

    def __getitem__(self, idx: int):
        """(uint8 HWC RGB image, int32 HW mask clipped to the classes) at
        ``image_size``, and with annotations the uint8 (O, H, W) instance
        masks."""
        try:
            img = _resize(load_image_rgb(self.image_paths[idx]), self.image_size, nearest=False)
            inst = self._instances(idx) if self.annotations is not None else None
            if self.mask_paths is not None:
                mask = _resize(load_mask(self.mask_paths[idx]), self.image_size, nearest=True)
                mask = np.clip(mask, 0, self.num_classes - 1).astype(np.int32)
            elif inst is not None:
                mask = inst.any(axis=0).astype(np.int32)  # the union is foreground, class 1
            else:
                mask = np.zeros(self.image_size, np.int32)
            return (img, mask) if inst is None else (img, mask, inst)
        except Exception:
            if self.strict:
                raise
            print(f"[MangoDataset] WARNING: failed to load item {idx} ({self.image_paths[idx]!r}); substituting zeros.")
            zeros = (np.zeros((*self.image_size, 3), np.uint8), np.zeros(self.image_size, np.int32))
            if self.annotations is not None:
                return (*zeros, np.zeros((self.max_instances, *self.image_size), np.uint8))
            return zeros


class BatchLoader:
    """Shuffling batch iterator over a :class:`MangoDataset`, yielding
    stacked numpy batches. Epoch ``e`` shuffles with
    ``np.random.default_rng(seed + e)``, as the JAX loader does.
    ``shard=(i, n)``: ``batch_size`` is the global batch, and this loader
    yields and decodes only its i-th of n equal slices of each (the rows a
    data-parallel rank takes), in the same epoch order."""

    def __init__(self, dataset: MangoDataset, batch_size: int, shuffle: bool = True, drop_last: bool = True,
                 seed: int = 0, shard: Tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard = shard
        if shard[1] > 1 and (batch_size % shard[1] or not drop_last):
            raise ValueError(f"a global batch of {batch_size} does not split into {shard[1]} equal full slices")

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def epoch(self, epoch_idx: int = 0) -> Iterator[Tuple[np.ndarray, ...]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        limit = len(self) * self.batch_size if self.drop_last else len(self.dataset)
        index, count = self.shard
        local = self.batch_size // count
        for start in range(0, limit, self.batch_size):
            rows = order[start : start + self.batch_size][index * local : (index + 1) * local]
            batch = self._load_native(rows) if getattr(self.dataset, "use_native", False) else None
            if batch is None:
                batch = tuple(np.stack(c) for c in zip(*(self.dataset[int(i)] for i in rows)))
            yield batch

    def prefetch_epoch(self, epoch_idx: int = 0, prefetch: int = 2) -> Iterator[Tuple[np.ndarray, ...]]:
        """:meth:`epoch` decoded ahead on a background thread, up to
        ``prefetch`` batches in flight; a loader error is raised here."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        done = object()
        error: list = []

        def producer():
            try:
                for batch in self.epoch(epoch_idx):
                    q.put(batch)
            except Exception as e:  # raised on the consumer's side
                error.append(e)
            finally:
                q.put(done)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while (item := q.get()) is not done:
            yield item
        t.join()
        if error:
            raise error[0]

    def _load_native(self, rows) -> Optional[Tuple[np.ndarray, ...]]:
        """The batch decoded on the thread pool, or None when a file fails
        (the caller then reads the items one at a time, which raises the
        cause, or substitutes zeros with ``strict=False``). A batch of PNGs
        without instances takes the JAX loader's own decoding and resizing,
        as the JAX package does; any other batch OpenCV's."""
        ds = self.dataset
        img_paths = [ds.image_paths[int(i)] for i in rows]
        mask_paths = [ds.mask_paths[int(i)] for i in rows] if ds.mask_paths is not None else None
        exact = ds.annotations is not None or not all(p.lower().endswith(".png") for p in img_paths)
        out = native_loader.load_batch(img_paths, mask_paths, ds.image_size, threads=ds.native_threads, exact=exact)
        if out is None:
            return None
        imgs, masks = out
        inst = np.stack([ds._instances(int(i)) for i in rows]) if ds.annotations is not None else None
        if masks is not None:
            masks = np.clip(masks, 0, ds.num_classes - 1).astype(np.int32)
        elif inst is not None:
            masks = inst.any(axis=1).astype(np.int32)
        else:
            masks = np.zeros((len(img_paths), *ds.image_size), np.int32)
        return (imgs, masks) if inst is None else (imgs, masks, inst)


def device_preprocess_batch(
    images_u8: torch.Tensor,
    masks: torch.Tensor,
    mean: Sequence[float],
    std: Sequence[float],
    draw: Optional[AugmentDraw] = None,
    num_classes: Optional[int] = None,
    instances: Optional[torch.Tensor] = None,
):
    """uint8 images (B, H, W, 3) and integer masks (B, H, W) → f32
    normalized images and the masks, augmented with ``draw``
    (``ops/image.py::draw_augment``) when it is given; with ``instances``
    (B, O, H, W) also the instance masks, int32, under the same draw as
    their image.

    With ``num_classes == 2`` the mask (and each instance, as ``> 0``)
    rides as an extra channel of the image's linear warp and is rounded
    back (so labels above 1 become 0, as in the JAX package); otherwise
    the mask and every instance channel are resampled nearest."""
    imgs = images_u8.float() / 255.0
    if draw is not None and num_classes == 2:
        c = imgs.shape[-1]
        planes = [imgs, (masks == 1).float()[..., None]]
        if instances is not None:
            planes.append((instances > 0).float().permute(0, 2, 3, 1))
        warped = augment_image(torch.cat(planes, dim=-1), draw)
        imgs = warped[..., :c]
        masks = torch.round(warped[..., c]).to(masks.dtype)
        if instances is not None:
            instances = torch.round(warped[..., c + 1 :].permute(0, 3, 1, 2)).to(torch.int32)
    elif draw is not None:
        imgs, masks = augment_pair(imgs, masks, draw)
        if instances is not None:
            warped = augment_labels(instances.to(torch.int32).permute(0, 2, 3, 1).float(), draw)
            instances = torch.round(warped).permute(0, 3, 1, 2).to(torch.int32)
    elif instances is not None:
        instances = instances.to(torch.int32)
    out = normalize(imgs, mean, std), masks
    return out if instances is None else (*out, instances)
