"""bwd_ms.train: the median, over the traced steps, of the device ms of
the program's span ``vast.train.backward`` (the backward, and the
gradients' reduction where sharded): the interval between its timing
events, device idle inside it included."""

from benchmark.metrics._spans import step_phase_ms


def read(obs):
    return step_phase_ms(obs, "vast.train.backward")
