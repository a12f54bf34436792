"""Device time a traced serving step of the stage ``stp3.temporal``: the
egopose concat and the temporal model, from the port's stage stamps, in
ms."""
from cardbench.metrics._spans import stage_ms


def read(summary, inputs):
    return stage_ms(summary, 'stp3.temporal')
