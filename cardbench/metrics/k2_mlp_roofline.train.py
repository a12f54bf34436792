"""K2's share of its roofline: the bound time of the traced steps' K2
launches (``counts/kernels.py``'s ``k2_mlp``) over the device time of the
kernel ``convnext_mlp_kernel`` in the trace."""
from cardbench.metrics._common import roofline

KERNEL = 'convnext_mlp_kernel'


def read(summary, inputs):
    return roofline(summary, inputs, KERNEL, 'k2_mlp')
