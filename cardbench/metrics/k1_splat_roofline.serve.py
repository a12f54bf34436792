"""K1's share of its roofline: the bound time of the traced steps' K1
launches (``counts/kernels.py``'s ``k1_splat``) over the device time of the
kernel ``splat_tile_kernel`` in the trace."""
from cardbench.metrics._common import roofline

KERNEL = 'splat_tile_kernel'


def read(summary, inputs):
    return roofline(summary, inputs, KERNEL, 'k1_splat')
