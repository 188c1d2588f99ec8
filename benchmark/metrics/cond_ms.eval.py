"""cond_ms.eval: the device ms of the traced evaluation's
``vast.eval.condition_features`` spans (the towers and the fusion of
each batch), summed."""

from benchmark.metrics._spans import eval_stage_ms


def read(obs):
    return eval_stage_ms(obs, "vast.eval.condition_features")
