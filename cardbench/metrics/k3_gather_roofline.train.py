"""K3's share of its roofline: the bound time of the traced steps' K3
launches (``counts/kernels.py``'s ``k3_gather``) over the device time of the
kernel ``gather_rows_kernel`` in the trace."""
from cardbench.metrics._common import roofline

KERNEL = 'gather_rows_kernel'


def read(summary, inputs):
    return roofline(summary, inputs, KERNEL, 'k3_gather')
