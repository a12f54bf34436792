"""Device time a traced train step of the stage ``train.update``: the clip
and Adam, in the update's graph, from the port's stage stamps, in ms."""
from cardbench.metrics._spans import stage_ms


def read(summary, inputs):
    return stage_ms(summary, 'train.update')
