"""paddle.vision.transforms of the port (numpy, HWC uint8 in).

Port of ``paddle_tpu/vision/transforms.py``: preprocessing stays numpy on
the host, one copy to the device a batch.
"""
from __future__ import annotations

import numbers
import random
from typing import List, Sequence

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __call__(self, img):
        return self._apply_image(img)


class ToTensor(BaseTransform):
    """HWC uint8 [0,255] -> CHW float32 [0,1]."""

    def __init__(self, data_format="CHW"):
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        img = img.astype("float32") / 255.0
        if self.data_format == "CHW":
            img = img.transpose(2, 0, 1)
        return img


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False):
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = np.asarray(mean, "float32")
        self.std = np.asarray(std, "float32")
        self.data_format = data_format

    def _apply_image(self, img):
        img = np.asarray(img, "float32")
        if self.data_format == "CHW":
            n = img.shape[0]
            return (img - self.mean[:n, None, None]) / self.std[:n, None, None]
        n = img.shape[-1]
        return (img - self.mean[:n]) / self.std[:n]


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear"):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.interpolation = interpolation

    def _apply_image(self, img):
        img = np.asarray(img)
        h, w = self.size
        ih, iw = img.shape[0], img.shape[1]
        if (ih, iw) == (h, w):
            return img
        if self.interpolation == "nearest":
            yi = (np.arange(h) * (ih / h)).astype(int).clip(0, ih - 1)
            xi = (np.arange(w) * (iw / w)).astype(int).clip(0, iw - 1)
            return img[yi][:, xi]
        # bilinear, align_corners=False (the JAX package's convention)
        dtype = img.dtype
        fimg = img.astype("float32")
        if fimg.ndim == 2:
            fimg = fimg[:, :, None]
        ys = (np.arange(h) + 0.5) * (ih / h) - 0.5
        xs = (np.arange(w) + 0.5) * (iw / w) - 0.5
        y0 = np.floor(ys).astype(int)
        x0 = np.floor(xs).astype(int)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]
        y0c = y0.clip(0, ih - 1)
        y1c = (y0 + 1).clip(0, ih - 1)
        x0c = x0.clip(0, iw - 1)
        x1c = (x0 + 1).clip(0, iw - 1)
        top = fimg[y0c][:, x0c] * (1 - wx) + fimg[y0c][:, x1c] * wx
        bot = fimg[y1c][:, x0c] * (1 - wx) + fimg[y1c][:, x1c] * wx
        out = top * (1 - wy) + bot * wy
        if img.ndim == 2:
            out = out[:, :, 0]
        if np.issubdtype(dtype, np.integer):
            out = np.round(out).clip(0, np.iinfo(dtype).max).astype(dtype)
        else:
            out = out.astype(dtype)
        return out


class CenterCrop(BaseTransform):
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        img = np.asarray(img)
        h, w = self.size
        ih, iw = img.shape[0], img.shape[1]
        top = max(0, (ih - h) // 2)
        left = max(0, (iw - w) // 2)
        return img[top : top + h, left : left + w]


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        img = np.asarray(img)
        if self.padding:
            p = self.padding
            pads = [(p, p), (p, p)] + [(0, 0)] * (img.ndim - 2)
            img = np.pad(img, pads)
        h, w = self.size
        ih, iw = img.shape[0], img.shape[1]
        top = random.randint(0, max(0, ih - h))
        left = random.randint(0, max(0, iw - w))
        return img[top : top + h, left : left + w]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5):
        self.prob = prob

    def _apply_image(self, img):
        if random.random() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1)):
        self.order = order

    def _apply_image(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[:, :, None]
        return img.transpose(self.order)
