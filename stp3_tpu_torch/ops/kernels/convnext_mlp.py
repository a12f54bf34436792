"""K2: the fused ConvNeXt MLP tail, as a Triton kernel for Hopper.

Replaces ``stp3_tpu/ops/pallas/convnext_mlp_kernel.py::convnext_mlp_pallas``
(kernel ``_mlp_kernel``). Over (N, C) rows it computes

    u = LayerNorm(h; scale, bias, eps=1e-6)   stats in fp32, var = E[x^2] - mean^2
    a = bf16(u) @ bf16(W1) + b1               fp32 accumulate, (N, 4C)
    g = gelu_tanh(a)                          fp32
    o = bf16(g) @ bf16(W2) + b2               fp32 accumulate, (N, C)
    y = x + gamma * o                         stored in x's dtype

with the rounding points of the JAX plain mirror ``_mlp_reference``.

Why Triton: per row tile the work is one normalisation reduction and two
tile-local products (64 -> 256 -> 64) whose operands and the (rows, 4C)
intermediate fit on chip. ``tl.dot`` emits Hopper's tensor-core
instructions, so Triton expresses the whole fused chain -- whose point is
that the (N, 4C) tensor never reaches device memory -- as well as
hand-written CUDA would.

What bounds it on an H100: bytes. Counted from the shapes, at C = 64 a
row reads h and x and writes y (3 x 128 B in bf16) against 2 x 64 x 256
x 2 = 65,536 FLOPs, about 170 FLOP/byte, below the ~295 FLOP/byte at
which the card's bf16 tensor cores, not its HBM, become the limit (H100
data sheet: 989 TFLOP/s, 3.35 TB/s); the unfused chain would also write
and re-read the (N, 256) hidden tensor and the LayerNorm / GELU
intermediates. The design keeps the hidden tile in registers and reads
each weight matrix once per program, from L2.

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

import torch

_BLOCK_M = 64       # rows per program: the wgmma M tile; ragged tail masked
_NUM_WARPS = 8      # the (64, 256) fp32 hidden tile spread over 256 threads
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


_KERNEL = None


def _kernel():
    """Build (once) and return the @triton.jit kernel. Triton is imported
    here, not at module import: CPU-only hosts have no triton."""
    global _KERNEL
    if _KERNEL is not None:
        return _KERNEL
    import triton
    import triton.language as tl

    @triton.jit
    def _mlp_kernel(h_ptr, x_ptr, out_ptr, scale_ptr, bias_ptr, w1_ptr, b1_ptr,
                    w2_ptr, b2_ptr, gamma_ptr, n_rows,
                    C: tl.constexpr, C4: tl.constexpr, BLOCK_M: tl.constexpr,
                    EPS: tl.constexpr, K0: tl.constexpr):
        pid = tl.program_id(0)
        rows = pid * BLOCK_M + tl.arange(0, BLOCK_M)
        cols = tl.arange(0, C)
        hid = tl.arange(0, C4)
        offs = rows[:, None].to(tl.int64) * C + cols[None, :]
        mask = (rows[:, None] < n_rows) & (cols[None, :] < C)

        h = tl.load(h_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(h, axis=1) / C
        var = tl.sum(h * h, axis=1) / C - mean * mean
        u = (h - mean[:, None]) / tl.sqrt(var[:, None] + EPS)
        u = (u * tl.load(scale_ptr + cols)[None, :]
             + tl.load(bias_ptr + cols)[None, :])

        w1 = tl.load(w1_ptr + cols[:, None] * C4 + hid[None, :])      # (C, 4C) bf16
        a = tl.dot(u.to(tl.bfloat16), w1, out_dtype=tl.float32)
        a = a + tl.load(b1_ptr + hid)[None, :]
        # tanh(z) = 1 - 2 / (exp(2z) + 1): exact limits at +-inf in fp32
        z = K0 * (a + 0.044715 * a * a * a)
        g = 0.5 * a * (2.0 - 2.0 / (tl.exp(2.0 * z) + 1.0))

        w2 = tl.load(w2_ptr + hid[:, None] * C + cols[None, :])       # (4C, C) bf16
        o = tl.dot(g.to(tl.bfloat16), w2, out_dtype=tl.float32)
        o = o + tl.load(b2_ptr + cols)[None, :]
        xr = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        y = xr + tl.load(gamma_ptr + cols)[None, :] * o
        tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=mask)

    _KERNEL = (_mlp_kernel, triton.cdiv)
    return _KERNEL


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
    """One launch of the Triton kernel on CUDA operands."""
    n, c = h.shape
    c4 = w1.shape[1]
    if c & (c - 1) or c4 & (c4 - 1) or c < 16:
        raise ValueError(f'kernel needs power-of-two C >= 16 and 4C, got {c}, {c4}')
    if not (h.is_contiguous() and x.is_contiguous()):
        raise ValueError('h and x must be contiguous (N, C) rows')
    kernel, cdiv = _kernel()
    f32 = torch.float32
    out = torch.empty_like(x)
    with torch.cuda.device(h.device):
        kernel[(cdiv(n, _BLOCK_M),)](
            h, x, out, scale.to(f32).contiguous(), bias.to(f32).contiguous(),
            w1.to(torch.bfloat16).contiguous(), b1.to(f32).contiguous(),
            w2.to(torch.bfloat16).contiguous(), b2.to(f32).contiguous(),
            gamma.to(f32).contiguous(), n,
            C=c, C4=c4, BLOCK_M=_BLOCK_M, EPS=_EPS, K0=_SQRT_2_OVER_PI,
            num_warps=_NUM_WARPS)
    convnext_mlp.launches += 1
    return out


class ConvNextMLP(torch.autograd.Function):
    """Forward: the Triton kernel for CUDA operands, the plain version for
    CPU ones. Backward: autograd through the plain version."""

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
