"""Image input preparation (port of stp3_tpu/utils/network.py::prepare_image)."""
from __future__ import annotations

import torch

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
    kw = dict(dtype=torch.float32, device=image.device)
    x = image.to(torch.float32) / 255.0
    x = (x - torch.tensor(IMAGENET_MEAN, **kw)) / torch.tensor(IMAGENET_STD, **kw)
    return x.to(dtype)
