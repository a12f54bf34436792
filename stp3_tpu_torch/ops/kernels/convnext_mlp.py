"""K2: the fused ConvNeXt MLP tail, a CUDA C++ kernel for Hopper.

Replaces ``stp3_tpu/ops/pallas/convnext_mlp_kernel.py::convnext_mlp_pallas``
(kernel ``_mlp_kernel``). Over (N, C) rows it computes

    u = LayerNorm(h; scale, bias, eps=1e-6)   stats in fp32, var = E[x^2] - mean^2
    a = bf16(u) @ bf16(W1) + b1               fp32 accumulate, (N, 4C)
    g = gelu_tanh(a)                          fp32
    o = bf16(g) @ bf16(W2) + b2               fp32 accumulate, (N, C)
    y = x + gamma * o                         stored in x's dtype

with the rounding points of the JAX plain mirror ``_mlp_reference``.

The kernel is ``csrc/convnext_mlp.cu`` (its comments say what bounds it
and why it is built the way it is: persistent CTAs with the weights
resident in shared memory, tiles brought in by bulk copies from a
producer warp, both products as wgmma with the hidden chunk fed from
registers); this module builds it with nvcc at first use, binds it with
ctypes and checks the arguments. It is built for C = 64, every
configuration's width; a CUDA tensor of another C is refused.

Backward: ``convnext_mlp`` is a ``torch.autograd.Function`` whose
backward is autograd through ``convnext_mlp_plain`` on the saved inputs,
the rematerialised plain backward of the JAX package
(``convnext_mlp_kernel.py::_bwd``, which has no backward kernel either):
the (N, 4C) hidden tensor exists only inside that backward. It returns
the gradients of h, x and all seven parameters.

Dispatch is on the tensor's device: a CPU tensor goes to the plain
version ``convnext_mlp_plain`` (the tests' path), a CUDA tensor launches
the kernel or raises. ``convnext_mlp.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from stp3_tpu_torch.ops.kernels.nvcc_build import load_library

_SQRT_2_OVER_PI = 0.7978845608028654
_EPS = 1e-6


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


def convnext_mlp_plain(h, x, scale, bias, w1, b1, w2, b2, gamma):
    """Line-for-line mirror of ``_mlp_reference``. The bf16 products with
    fp32 accumulation are fp32 matmuls of bf16-rounded operands (exact
    products, fp32 sums), as ``preferred_element_type=float32`` gives."""
    hf = h.float()
    mean = hf.mean(-1, keepdim=True)
    var = (hf * hf).mean(-1, keepdim=True) - mean * mean
    u = (hf - mean) * torch.rsqrt(var + _EPS)
    u = u * scale.float() + bias.float()
    bf = torch.bfloat16
    a = u.to(bf).float() @ w1.to(bf).float() + b1.float()
    g = _gelu_tanh(a)
    o = g.to(bf).float() @ w2.to(bf).float() + b2.float()
    y = x.float() + gamma.float() * o
    return y.to(x.dtype)


_LIB = {}


def build() -> dict:
    """Build (or reuse) and bind the kernel library; returns the build info
    from ``nvcc_build.load_library``."""
    lib, info = load_library('convnext_mlp', ['convnext_mlp.cu'])
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.convnext_mlp
    fn.argtypes = [ptr, ptr, ptr, i32] + [ptr] * 7 + [i32, i32, ptr]
    fn.restype = ctypes.c_int
    lib.convnext_mlp_channels.restype = ctypes.c_int
    lib.convnext_mlp_smem_bytes.argtypes = [i32]
    lib.convnext_mlp_smem_bytes.restype = ctypes.c_int
    _LIB['convnext_mlp'] = fn
    _LIB['channels'] = lib.convnext_mlp_channels()
    _LIB['smem_bytes'] = lib.convnext_mlp_smem_bytes
    return info


def _kernel():
    if 'convnext_mlp' not in _LIB:
        build()
    return _LIB['convnext_mlp'], _LIB['channels']


def shared_memory_bytes(dtype: torch.dtype) -> int:
    """The dynamic shared memory a CTA of the kernel takes for fp32 or bf16 rows."""
    _kernel()
    return _LIB['smem_bytes'](0 if dtype == torch.float32 else 1)


def _check(h, x, scale, bias, w1, b1, w2, b2, gamma):
    n, c = h.shape
    c4 = w1.shape[1]
    if x.shape != (n, c):
        raise ValueError(f'x {tuple(x.shape)} != h {tuple(h.shape)}')
    if w1.shape != (c, c4) or w2.shape != (c4, c):
        raise ValueError(f'w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not '
                         f'match C={c}')
    for name, v, k in (('scale', scale, c), ('bias', bias, c), ('b1', b1, c4),
                       ('b2', b2, c), ('gamma', gamma, c)):
        if v.shape != (k,):
            raise ValueError(f'{name} {tuple(v.shape)} != ({k},)')
    if h.dtype not in (torch.float32, torch.bfloat16) or x.dtype != h.dtype:
        raise TypeError(f'h/x must share fp32 or bf16, got {h.dtype}/{x.dtype}')
    devs = {t.device for t in (h, x, scale, bias, w1, b1, w2, b2, gamma)}
    if len(devs) != 1:
        raise ValueError(f'all operands must share one device, got {devs}')


def _launch(h, x, scale, bias, w1, b1, w2, b2, gamma):
    """One launch of the kernel on CUDA operands."""
    n, c = h.shape
    kernel, channels = _kernel()
    if c != channels:
        raise ValueError(f'the kernel is built for C={channels}, got C={c}')
    if not (h.is_contiguous() and x.is_contiguous()):
        raise ValueError('h and x must be contiguous (N, C) rows')
    if (h.data_ptr() | x.data_ptr()) % 16:
        raise ValueError('h and x must start on a 16-byte boundary')
    f32, bf16 = torch.float32, torch.bfloat16
    params = [t.to(f32).contiguous() for t in (scale, bias, b1, b2, gamma)]
    w1, w2 = (w.to(bf16).contiguous() for w in (w1, w2))
    out = torch.empty_like(x)
    if n == 0:
        return out
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(h.data_ptr(), x.data_ptr(), out.data_ptr(), 0 if h.dtype == f32 else 1,
                     params[0].data_ptr(), params[1].data_ptr(), w1.data_ptr(),
                     params[2].data_ptr(), w2.data_ptr(), params[3].data_ptr(),
                     params[4].data_ptr(), n, c, stream)
    if err != 0:
        raise RuntimeError(f'convnext_mlp kernel launch failed: cudaError {err}')
    convnext_mlp.launches += 1
    return out


class ConvNextMLP(torch.autograd.Function):
    """Forward: the kernel for CUDA operands, the plain version for CPU
    ones. Backward: autograd through the plain version."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        if args[0].device.type == 'cpu':
            return convnext_mlp_plain(*args)
        return _launch(*args)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y = convnext_mlp_plain(*inputs)
        grads = iter(torch.autograd.grad(y, [t for t in inputs if t.requires_grad], g))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


def convnext_mlp(h, x, scale, bias, w1, b1, w2, b2, gamma):
    """Fused LN + MLP + layer-scale residual over rows, differentiable in
    every argument.

    h, x: (N, C) fp32 or bf16, contiguous; scale, bias, gamma, b2: (C,);
    w1: (C, 4C); b1: (4C,); w2: (4C, C). Returns (N, C) in x's dtype.
    """
    args = (h, x, scale, bias, w1, b1, w2, b2, gamma)
    _check(*args)
    if h.device.type not in ('cpu', 'cuda'):
        raise RuntimeError(f'convnext_mlp: no kernel for device {h.device}')
    return ConvNextMLP.apply(*args)


convnext_mlp.launches = 0
