"""Model FLOPs of the traced steps over the traced window, as a share of
the peak of the configuration's precision (989 TFLOP/s bf16, 67 fp32)."""
from cardbench.metrics._common import mfu as read  # noqa: F401
