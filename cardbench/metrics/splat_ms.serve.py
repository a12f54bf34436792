"""Device time a traced serving step of the stage ``stp3.splat``: the
geometry, the lift and K1's splat of the rf frames, from the port's stage
stamps, in ms."""
from cardbench.metrics._spans import stage_ms


def read(summary, inputs):
    return stage_ms(summary, 'stp3.splat')
