"""Hand-written Hopper kernels, each beside its plain PyTorch version.

K1 ``bev_splat`` with its per-frame entries ``bev_pool_v1`` / ``bev_pool_v2``
and K3 ``gather_rows`` (CUDA C++, csrc/bev_pool.cu), K2 ``convnext_mlp``
(CUDA C++, csrc/convnext_mlp.cu) and K4 ``lift_splat`` (CUDA C++,
csrc/lift_splat.cu), each built by nvcc at first use. A wrapper
takes the plain version only for CPU tensors; for a CUDA tensor it
launches its kernel or raises.
"""


def launch_counters() -> dict:
    """Each kernel's launch counter, by name: the wrapper whose
    ``launches`` attribute it is (raised once for each launch)."""
    from stp3_tpu_torch.ops.kernels import bev_splat, convnext_mlp, lift_splat
    return {'bev_splat': bev_splat.bev_splat_accumulate, 'bev_pool_v1': bev_splat.bev_pool_v1,
            'bev_pool_v2': bev_splat.bev_pool_v2, 'convnext_mlp': convnext_mlp.convnext_mlp,
            'gather_rows': bev_splat.gather_rows,
            'lift_splat': lift_splat.lift_splat_accumulate}
