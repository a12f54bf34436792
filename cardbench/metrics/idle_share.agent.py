"""The share of the traced window in which no kernel ran on the device."""
from cardbench.metrics._common import idle_share as read  # noqa: F401
