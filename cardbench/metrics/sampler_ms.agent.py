"""Host time a traced tick of the agent's candidate sampler: the port's
``agent.sample`` range around ``sample_trajectories``, in ms."""
from cardbench.metrics._spans import host_ms


def read(summary, inputs):
    return host_ms(summary, 'agent.sample')
