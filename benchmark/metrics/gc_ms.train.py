"""gc_ms.train: the host ms of the program's garbage-collection spans
(``vast.gc.gen<N>``) during the traced steps, over the number of
steps."""

from benchmark.metrics._spans import gc_ms_per_step


def read(obs):
    return gc_ms_per_step(obs)
