"""The bf16 serving policy (port of stp3_tpu/utils/precision.py as
``bench.py`` applies it): params, images, candidate trajectories, the GT
trajectory and the target point are cast to bf16; intrinsics, extrinsics
and ego-motion stay fp32, because a shifted voxel changes the output.

An explicit cast (``model.to(policy_dtype(cfg))`` and a cast of each
of those inputs), not ``torch.autocast``: autocast would pick per-op
types of its own and re-cast fp32 geometry inside the model.
"""
from __future__ import annotations

import torch

_POLICY = {16: torch.bfloat16, 32: torch.float32}


def policy_dtype(cfg) -> torch.dtype:
    """cfg.PRECISION 16 -> bf16; anything else -> fp32."""
    return _POLICY.get(int(cfg.PRECISION), torch.float32)


def pin_fp32_math() -> None:
    """Make fp32 mean fp32 on the card: no TF32 in matmuls or cuDNN
    convolutions (cuDNN's default is TF32). The bf16 path is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
