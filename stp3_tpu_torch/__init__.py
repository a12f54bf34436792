"""stp3_tpu_torch: the PyTorch / CUDA port of stp3_tpu for NVIDIA Hopper.

The JAX package ``stp3_tpu`` is the reference; every module here mirrors
its counterpart's file layout, param tree (so ``utils/from_flax.py`` can
load a flax tree leaf by leaf) and channels-last public layout. Every
TPU kernel of the JAX package is a hand-written Hopper kernel here:
``ops/kernels/bev_splat.py`` (CUDA C++, ``csrc/bev_pool.cu``: the BEV
splat and its backward row gather), ``ops/kernels/convnext_mlp.py``
(Triton) and ``ops/kernels/lift_splat.py`` (CUDA C++,
``csrc/lift_splat.cu``: the fused lift + splat). This package never
imports jax or flax.
"""

__version__ = '0.1.0'
