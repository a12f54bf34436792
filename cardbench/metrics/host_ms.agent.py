"""The agent tick's host time: each traced tick's wall time less the time
the device was busy inside it, the mean over the ticks, in ms."""


def read(summary, inputs):
    ticks = summary.step_busy_s()
    if not ticks:
        return None
    return 1e3 * sum(wall - busy for wall, busy in ticks) / len(ticks)
