"""Device time a traced train step of the stage ``train.backward``: the
backward, from the port's stage stamps, in ms."""
from cardbench.metrics._spans import stage_ms


def read(summary, inputs):
    return stage_ms(summary, 'train.backward')
