"""Image transforms for input pipelines (the port's own copy of
paddle_tpu/data/transforms.py, host-side numpy).

Capability-equivalent of Paddle's image utilities
(python/paddle/dataset/image.py: simple_transform, resize_short,
center_crop, random_crop, left_right flip): pure numpy, no cv2 / PIL
(bilinear resize implemented directly), HWC layout, the layout of the
port's NHWC models; `to_chw` is provided for parity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def resize_bilinear_np(img: np.ndarray, out_hw: Tuple[int, int]
                       ) -> np.ndarray:
    """Bilinear resize, HWC float (half-pixel centers)."""
    h, w = img.shape[:2]
    oh, ow = out_hw
    ys = (np.arange(oh) + 0.5) * h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * w / ow - 0.5
    y0 = np.clip(np.floor(ys), 0, h - 1).astype(int)
    x0 = np.clip(np.floor(xs), 0, w - 1).astype(int)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0, 1)[:, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, :, None]
    img = img.astype(np.float32)
    top_rows = img[y0]
    bot_rows = img[y1]
    top = top_rows[:, x0] * (1 - wx) + top_rows[:, x1] * wx
    bot = bot_rows[:, x0] * (1 - wx) + bot_rows[:, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_short(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the shorter edge == size (image.py resize_short)."""
    h, w = img.shape[:2]
    if h <= w:
        return resize_bilinear_np(img, (size, max(int(w * size / h), 1)))
    return resize_bilinear_np(img, (max(int(h * size / w), 1), size))


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    y = max((h - size) // 2, 0)
    x = max((w - size) // 2, 0)
    return img[y:y + size, x:x + size]


def random_crop(img: np.ndarray, size: int,
                rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    rng = rng or np.random
    h, w = img.shape[:2]
    y = rng.randint(0, max(h - size, 0) + 1)
    x = rng.randint(0, max(w - size, 0) + 1)
    return img[y:y + size, x:x + size]


def left_right_flip(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1]


def normalize(img: np.ndarray, mean, std) -> np.ndarray:
    return (img.astype(np.float32) - np.asarray(mean, np.float32)) \
        / np.asarray(std, np.float32)


def to_chw(img: np.ndarray) -> np.ndarray:
    """HWC -> CHW (Paddle's layout; the port's models take HWC)."""
    return np.transpose(img, (2, 0, 1))


def simple_transform(img: np.ndarray, resize_size: int, crop_size: int,
                     is_train: bool,
                     mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
                     rng: Optional[np.random.RandomState] = None
                     ) -> np.ndarray:
    """The standard train/eval pipeline (image.py simple_transform):
    resize-short -> random/center crop -> random flip (train) ->
    normalize. Returns HWC float32."""
    img = resize_short(img, resize_size)
    if is_train:
        img = random_crop(img, crop_size, rng)
        r = rng or np.random
        if r.randint(2):
            img = left_right_flip(img)
    else:
        img = center_crop(img, crop_size)
    return normalize(img, mean, std)
