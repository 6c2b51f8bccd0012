"""Synthetic CIFAR-10-like images (a copy of
``repro_torch/data/cifar.py::synthetic_cifar``): a deterministic 10-class
32 x 32 x 3 set of Gaussian blobs over fixed per-class templates."""
from __future__ import annotations

import numpy as np


def synthetic_cifar(n: int, *, seed: int = 0,
                    split: str = "train") -> tuple[np.ndarray, np.ndarray]:
    """(images (n, 32, 32, 3) f32 in [0, 1], labels (n,) int32)."""
    rng = np.random.default_rng(seed + (10_007 if split == "test" else 0))
    tmpl_rng = np.random.default_rng(1234)
    templates = tmpl_rng.random((10, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    noise = rng.normal(0, 0.25, size=(n, 32, 32, 3)).astype(np.float32)
    images = np.clip(templates[labels] + noise, 0.0, 1.0)
    return images, labels
