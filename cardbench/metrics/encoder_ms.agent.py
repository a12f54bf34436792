"""Device time a traced agent tick of the stage ``stp3.encoder``: the
encoder (EfficientNet over every camera image), from the port's stage
stamps, in ms."""
from cardbench.metrics._spans import stage_ms


def read(summary, inputs):
    return stage_ms(summary, 'stp3.encoder')
