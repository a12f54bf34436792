"""Hand-written Hopper kernels, each beside its plain PyTorch version.

K1 ``bev_splat`` (CUDA C++, csrc/bev_pool.cu) and K2 ``convnext_mlp``
(Triton). A wrapper takes the plain version only for CPU tensors; for a
CUDA tensor it launches its kernel or raises.
"""
