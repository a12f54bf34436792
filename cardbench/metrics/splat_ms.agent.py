"""Device time a traced agent tick of the stage ``stp3.splat``: the new
frame's splat by the column plan, then the cache's warp and discounted
accumulate, from the port's stage stamps, in ms."""
from cardbench.metrics._spans import stage_ms


def read(summary, inputs):
    return stage_ms(summary, 'stp3.splat')
