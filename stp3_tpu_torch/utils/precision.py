"""The bf16 policy (port of stp3_tpu/utils/precision.py).

Serving (as ``bench.py`` applies it): params, images, candidate
trajectories, the GT trajectory and the target point are cast to bf16;
intrinsics, extrinsics and ego-motion stay fp32, because a shifted voxel
changes the output.

Training: the parameters stay fp32 masters in the optimizer, and each
step runs the model with bf16 copies of the floating ones
(``cast_parameters`` + ``torch.func.functional_call``), the counterpart of
``cast_floating(params, bf16)`` in the JAX trainer. The copy is an
autograd op, so the gradients land on the fp32 masters. Geometry inputs,
the uncertainty weights and the losses stay fp32.

An explicit cast, not ``torch.autocast``: autocast would pick per-op
types of its own and re-cast fp32 geometry inside the model, which is a
different function from the JAX package's.
"""
from __future__ import annotations

from typing import Dict

import torch

_POLICY = {16: torch.bfloat16, 32: torch.float32, 64: torch.float64}


def policy_dtype(cfg) -> torch.dtype:
    """cfg.PRECISION 16 -> bf16; 64 -> float64 (a precision reference for
    the fp32 step, on the CPU: the kernels take fp32 and bf16 only);
    anything else -> fp32."""
    return _POLICY.get(int(cfg.PRECISION), torch.float32)


def cast_parameters(module: torch.nn.Module, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{name: parameter in ``dtype``} for every floating parameter of
    ``module``: the argument of ``torch.func.functional_call``. The cast is
    differentiable; in fp32 it is the parameter itself."""
    return {name: p.to(dtype) for name, p in module.named_parameters()
            if p.is_floating_point()}


def pin_fp32_math() -> None:
    """Make fp32 mean fp32 on the card: no TF32 in matmuls or cuDNN
    convolutions (cuDNN's default is TF32). The bf16 path is unaffected."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
