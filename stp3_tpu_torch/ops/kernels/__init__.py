"""Hand-written Hopper kernels, each beside its plain PyTorch version.

K1 ``bev_splat`` with its per-frame entries ``bev_pool_v1`` / ``bev_pool_v2``
and K3 ``gather_rows`` (CUDA C++, csrc/bev_pool.cu), K2 ``convnext_mlp``
(Triton) and K4 ``lift_splat`` (CUDA C++, csrc/lift_splat.cu). A wrapper
takes the plain version only for CPU tensors; for a CUDA tensor it
launches its kernel or raises.
"""
