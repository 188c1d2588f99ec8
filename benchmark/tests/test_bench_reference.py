"""The plain reference against vast_tpu_torch at tiny widths on the CPU.

With the program computing in fp32, as the reference does, every
compared number comes out at fp32 round-off: the reference follows the
program's draws (dropout, crop, audio clip), layers and optimizer."""

import pytest
import torch

from benchmark import harness, weights
from benchmark.reference.vast_ref import VastRef
from benchmark.tests import tiny


@pytest.mark.parametrize("name", ["evag_ret_train", "clipl_ret_train"])
def test_same_parameters(name):
    cfg = tiny.cell(name)["config_spec"]
    prog = harness.build_program(cfg, "cpu", torch.float32)
    ref = VastRef(cfg)
    shapes = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert {n: tuple(p.shape) for n, p in prog.named_parameters()} == shapes
    weights.init_weights(prog, 3, "cpu")
    weights.init_weights(ref, 3, "cpu")
    assert not ref.load_state_dict(prog.state_dict(), strict=False
                                   ).missing_keys
    for n, p in ref.named_parameters():
        assert torch.equal(p, dict(prog.named_parameters())[n])


@pytest.fixture
def fp32_program(monkeypatch):
    build = harness.build_program
    monkeypatch.setattr(harness, "build_program",
                        lambda cfg, device, dtype, p=None, remat=None:
                        build(cfg, device, torch.float32, torch.float32,
                              remat))


@pytest.mark.parametrize("name", ["evag_ret_train", "clipl_ret_train"])
def test_train_steps_follow_the_program(name, fp32_program):
    from benchmark.runners import train

    out = train.run(tiny.ctx(name))
    for key, c in out["checks"].items():
        assert c["value"] < 2e-5, (key, c["value"])


def test_retrieval_follows_the_program(fp32_program):
    from benchmark.runners import ret_eval

    out = ret_eval.run(tiny.ctx("clipl_ret_eval"))
    for key, c in out["checks"].items():
        assert c["value"] < 1e-5, (key, c["value"])
