"""Synthetic image-classification datasets (offline stand-ins for
USPS/MNIST/FashionMNIST/CIFAR in the paper's protocol).  The port's own
copy of ``repro/data/synthetic.py`` (pure numpy): for a given spec and
seed every array is identical to the JAX package's.

Each class is a mixture of prototype templates plus per-sample deformation and
noise, giving a real train/test generalization gap: memorization accuracy
(train-set accuracy of an overfitted model) and generalization accuracy
(test-set accuracy) behave like the paper's M_A / G_A.

Difficulty knobs mirror the paper's dataset ladder:
  usps_like    16x16, 10 classes, 2 prototypes/class, low noise
  mnist_like   28x28, 10 classes, 3 prototypes/class, low noise
  fashion_like 28x28, 10 classes, 4 prototypes/class, medium noise
  cifar_like   32x32x3 flattened, 10/100 classes, 6 prototypes, high noise
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np


class Dataset(NamedTuple):
    x_train: np.ndarray   # (N, D) float32 in [0, 1]
    y_train: np.ndarray   # (N,) int32
    x_val: np.ndarray
    y_val: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int

    @property
    def dim(self) -> int:
        return self.x_train.shape[1]


@dataclasses.dataclass(frozen=True)
class SyntheticSpec:
    side: int = 16
    channels: int = 1
    num_classes: int = 10
    prototypes_per_class: int = 2
    noise: float = 0.15
    warp: float = 0.3             # prototype-mixing deformation strength
    n_train: int = 4096
    n_val: int = 512
    n_test: int = 1024
    seed: int = 0


PRESETS = {
    "usps_like": SyntheticSpec(side=16, prototypes_per_class=2, noise=0.12,
                               n_train=4096),
    "mnist_like": SyntheticSpec(side=28, prototypes_per_class=3, noise=0.12,
                                n_train=8192),
    "fashion_like": SyntheticSpec(side=28, prototypes_per_class=4, noise=0.20,
                                  warp=0.45, n_train=8192),
    "svhn_like": SyntheticSpec(side=32, channels=3, prototypes_per_class=5,
                               noise=0.25, warp=0.5, n_train=8192),
    "cifar10_like": SyntheticSpec(side=32, channels=3, prototypes_per_class=6,
                                  noise=0.30, warp=0.6, n_train=8192),
    "cifar100_like": SyntheticSpec(side=32, channels=3, num_classes=100,
                                   prototypes_per_class=4, noise=0.30,
                                   warp=0.6, n_train=8192),
}


def _smooth(img: np.ndarray, side: int, channels: int) -> np.ndarray:
    """Cheap separable blur so prototypes have spatial structure."""
    im = img.reshape(side, side, channels)
    k = np.array([0.25, 0.5, 0.25])
    for axis in (0, 1):
        im = (np.apply_along_axis(lambda v: np.convolve(v, k, mode="same"),
                                  axis, im))
    return im.reshape(-1)


def make(spec_or_name: SyntheticSpec | str) -> Dataset:
    spec = PRESETS[spec_or_name] if isinstance(spec_or_name, str) else spec_or_name
    rng = np.random.default_rng(spec.seed)
    D = spec.side * spec.side * spec.channels
    C, P = spec.num_classes, spec.prototypes_per_class

    protos = rng.uniform(0, 1, size=(C, P, D)).astype(np.float32)
    protos = np.stack([[_smooth(p, spec.side, spec.channels) for p in row]
                       for row in protos])
    # normalize prototypes to [0, 1]
    protos -= protos.min(axis=-1, keepdims=True)
    protos /= np.maximum(protos.max(axis=-1, keepdims=True), 1e-6)

    def sample(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
        r = np.random.default_rng(seed)
        y = r.integers(0, C, size=n).astype(np.int32)
        pid = r.integers(0, P, size=n)
        base = protos[y, pid]
        # deformation: mix with a second prototype of the same class
        pid2 = r.integers(0, P, size=n)
        alpha = r.uniform(0, spec.warp, size=(n, 1)).astype(np.float32)
        base = (1 - alpha) * base + alpha * protos[y, pid2]
        x = base + r.normal(0, spec.noise, size=(n, D)).astype(np.float32)
        return np.clip(x, 0, 1).astype(np.float32), y

    x_tr, y_tr = sample(spec.n_train, spec.seed + 1)
    x_va, y_va = sample(spec.n_val, spec.seed + 2)
    x_te, y_te = sample(spec.n_test, spec.seed + 3)
    return Dataset(x_tr, y_tr, x_va, y_va, x_te, y_te, C)


def patches(x: np.ndarray, side: int, channels: int, patch: int) -> np.ndarray:
    """Flattened images -> (N, n_patches, patch*patch*channels) for ViT."""
    n = x.shape[0]
    im = x.reshape(n, side, side, channels)
    g = side // patch
    im = im.reshape(n, g, patch, g, patch, channels)
    return im.transpose(0, 1, 3, 2, 4, 5).reshape(n, g * g, patch * patch * channels)
