"""paddle.vision.datasets of the port: MNIST, FashionMNIST, Cifar10 and
Cifar100.

Port of ``paddle_tpu/vision/datasets.py``. Nothing is downloaded: a
constructor reads the local files it is given (MNIST's gzip'd IDX pair,
CIFAR's python tarball), and with none (or ``backend="fake"``) it makes
deterministic synthetic data of the real shapes and dtypes from a fixed
seed, the same arrays as the JAX package's.
"""
from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional

import numpy as np

from ..io import Dataset


def _fake(shape_img, n, num_classes, seed):
    r = np.random.RandomState(seed)
    imgs = (r.rand(n, *shape_img) * 255).astype("uint8")
    labels = r.randint(0, num_classes, size=(n,)).astype("int64")
    return imgs, labels


class MNIST(Dataset):
    """mode: 'train' | 'test'. With no local files, synthesizes
    shape-faithful fake data (28x28 grayscale, 10 classes)."""

    def __init__(
        self,
        image_path: Optional[str] = None,
        label_path: Optional[str] = None,
        mode: str = "train",
        transform: Optional[Callable] = None,
        download: bool = True,
        backend: Optional[str] = None,
    ):
        self.mode = mode
        self.transform = transform
        if image_path and label_path and os.path.exists(image_path):
            with gzip.open(image_path, "rb") as f:
                magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
                self.images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)
            with gzip.open(label_path, "rb") as f:
                struct.unpack(">II", f.read(8))
                self.labels = np.frombuffer(f.read(), dtype=np.uint8).astype("int64")
        else:
            n = 2048 if mode == "train" else 512
            self.images, self.labels = _fake((28, 28), n, 10, seed=0 if mode == "train" else 1)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype("float32")[None] / 255.0
        return img, np.asarray([self.labels[idx]], dtype="int64")

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class Cifar10(Dataset):
    _NUM_CLASSES = 10

    def __init__(
        self,
        data_file: Optional[str] = None,
        mode: str = "train",
        transform: Optional[Callable] = None,
        download: bool = True,
        backend: Optional[str] = None,
    ):
        self.mode = mode
        self.transform = transform
        self._num_classes = self._NUM_CLASSES
        if data_file and os.path.exists(data_file):
            imgs, labels = [], []
            with tarfile.open(data_file, "r:gz") as tf:
                names = [
                    n for n in tf.getnames()
                    if ("data_batch" in n if mode == "train" else "test_batch" in n)
                ]
                for name in sorted(names):
                    d = pickle.load(tf.extractfile(name), encoding="bytes")
                    imgs.append(np.asarray(d[b"data"]).reshape(-1, 3, 32, 32))
                    labels.extend(d.get(b"labels", d.get(b"fine_labels")))
            self.images = np.concatenate(imgs).transpose(0, 2, 3, 1)  # HWC
            self.labels = np.asarray(labels, "int64")
        else:
            n = 2048 if mode == "train" else 512
            self.images, self.labels = _fake(
                (32, 32, 3), n, self._num_classes,
                seed=2 if mode == "train" else 3,
            )

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype("float32").transpose(2, 0, 1) / 255.0
        return img, np.asarray([self.labels[idx]], dtype="int64")

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    _NUM_CLASSES = 100
