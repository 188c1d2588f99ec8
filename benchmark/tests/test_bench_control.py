"""The correctness check fails what it must: the control (the reference
in fp8 products) reads above the program, and a run whose timed path is
broken underneath comes out not correct. CPU, tiny widths; the cells'
own limits, set from readings at full size on the card, hold here."""

import pytest

from benchmark.tests import tiny


def test_train_control_reads_above_the_program():
    from benchmark.runners import train

    rows = {r["kind"]: r for r in train.calibrate(tiny.ctx(
        "evag_ret_train"), True)}
    prog, ctl = rows["program"], rows["control_fp8"]
    assert max(ctl[k] / prog[k] for k in ("loss_gap", "change_norm_gap")) > 2


def test_eval_control_reads_above_the_program():
    from benchmark.runners import ret_eval

    rows = {r["kind"]: r for r in ret_eval.calibrate(tiny.ctx(
        "clipl_ret_eval"), True)}
    prog, ctl = rows["program"], rows["control_fp8"]
    assert ctl["cond_seq_gap"] > 3 * prog["cond_seq_gap"]


def test_unchanged_state_is_not_correct(monkeypatch):
    """A step that returns its state unchanged."""
    from vast_tpu_torch.training import optimizer

    from benchmark.runners import train

    monkeypatch.setattr(optimizer.GroupedAdam, "step",
                        lambda self, window_sum=False: True)
    out = train.run(tiny.ctx("evag_ret_train"))
    assert not tiny.correct(out)
    assert out["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["evag_ret_train", "clipl_ret_train"])
def test_vision_lr_fault_is_not_correct(name, monkeypatch):
    """A fault confined to one parameter group: the vision tower stepped
    at ten times its learning rate (``clip_lr``)."""
    from vast_tpu_torch.training import optimizer

    from benchmark.runners import train

    init = optimizer.GroupedAdam.__init__

    def wrong_clip_lr(self, *a, **kw):
        init(self, *a, **kw)
        self.lrs["clip"] *= 10.0

    monkeypatch.setattr(optimizer.GroupedAdam, "__init__", wrong_clip_lr)
    out = train.run(tiny.ctx(name))
    assert not tiny.correct(out)
    assert out["checks"]["change_norm_gap"]["value"] > 5


def test_half_batch_is_not_correct(monkeypatch):
    """A step that leaves out half of its batch and takes the mean over
    the rest."""
    from vast_tpu_torch.training import step as step_mod

    from benchmark.runners import train

    make = step_mod.make_train_step

    def halved(*a, **kw):
        inner = make(*a, **kw)

        def step(state, batch, generator):
            return inner(state, train._half(batch), generator)
        return step

    monkeypatch.setattr(step_mod, "make_train_step", halved)
    out = train.run(tiny.ctx("evag_ret_train"))
    assert not tiny.correct(out)


def test_altered_answer_is_not_correct(monkeypatch):
    """An ITM score altered where the rerank produces it: each candidate's
    first text in every grouped call."""
    from vast_tpu_torch.models.vast import VASTModel

    from benchmark.runners import ret_eval

    grouped = VASTModel.compute_slice_scores_grouped

    def altered(self, cond, ids, mask):
        out = grouped(self, cond, ids, mask).clone()
        first = out.view(cond.shape[0], -1)[:, 0]
        first.zero_()
        return out

    monkeypatch.setattr(VASTModel, "compute_slice_scores_grouped", altered)
    out = ret_eval.run(tiny.ctx("clipl_ret_eval"))
    assert not tiny.correct(out)
