"""Image input preparation and its inverse for display (port of
stp3_tpu/utils/network.py::prepare_image and denormalise_image)."""
from __future__ import annotations

import numpy as np
import torch

from stp3_tpu_torch.utils.device import constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def prepare_image(image: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Wire-format image -> model input on the device.

    uint8 RGB is divided by 255 and ImageNet-normalised in fp32 (uint8/255
    has 8 significant bits; normalising in bf16 would round them), then
    cast once to ``dtype``. A float image counts as already normalised and
    is only cast."""
    if image.dtype != torch.uint8:
        return image.to(dtype)
    mean, std = (constant(v, torch.float32, image.device) for v in (IMAGENET_MEAN, IMAGENET_STD))
    x = image.to(torch.float32) / 255.0
    x = (x - mean) / std
    return x.to(dtype)


def denormalise_image(img: np.ndarray) -> np.ndarray:
    """Inverse ImageNet normalisation for visualisation (the reference's
    ``NormalizeInverse``, network.py:33-43): float in [0, 1]. A uint8
    wire-format image is raw RGB already: only scaled."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    std, mean = np.asarray(IMAGENET_STD, np.float32), np.asarray(IMAGENET_MEAN, np.float32)
    return np.clip(img * std + mean, 0.0, 1.0)
