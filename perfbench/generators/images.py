"""Image batches for a classifier: a pool of ``pool_batches`` batches of
``batch`` synthetic CIFAR images (``split``), made from the seed and moved
to the device once."""
from __future__ import annotations

import torch

from yardstick.cifar_data import synthetic_cifar


def pool(mix: dict, seed: int, dev) -> torch.Tensor:
    """(pool_batches, batch, 32, 32, 3) f32 images on ``dev``."""
    n = mix["batch"] * mix["pool_batches"]
    x, _ = synthetic_cifar(n, seed=seed, split=mix["split"])
    return torch.from_numpy(x).to(dev).view(mix["pool_batches"],
                                            mix["batch"], *x.shape[1:])
