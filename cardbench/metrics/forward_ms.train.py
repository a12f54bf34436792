"""Device time a traced train step of the stage ``train.forward``: labels,
forward and losses, from the port's stage stamps, in ms."""
from cardbench.metrics._spans import stage_ms


def read(summary, inputs):
    return stage_ms(summary, 'train.forward')
