"""Device time a traced serving step of the stage ``stp3.future``: the
present distribution and the future prediction, from the port's stage
stamps, in ms."""
from cardbench.metrics._spans import stage_ms


def read(summary, inputs):
    return stage_ms(summary, 'stp3.future')
