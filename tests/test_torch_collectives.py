"""The port's collectives (``vast_tpu_torch.parallel.collectives``) in
worlds of 1, 2 and 3 gloo processes on the CPU.

The semantics ``tests/test_multihost_proc.py`` holds ``vast_tpu``'s to:
``gather_array`` concatenates ragged per-rank rows in rank order (numpy
and tensors), ``gather_list`` concatenates lists of JSON items,
``sum_across_hosts`` sums (here in several chunks); and the reference's
two autograd gathers: ``all_gather_with_grad``'s gradient equals one
process's autograd over the concatenation of every rank's rows and
losses, ``all_gather_detached`` carries none. Ranks are spawned
(``tests/torch_dist_workers.py``) and meet through a ``file://``
rendezvous under ``tmp_path``.
"""

import numpy as np
import pytest
import torch

from tests import torch_dist_workers as w
from vast_tpu_torch import parallel
from vast_tpu_torch.parallel import collectives as col


@pytest.fixture(scope="module", params=[2, 3], ids=lambda n: f"world{n}")
def ranks(request, tmp_path_factory):
    world = request.param
    return world, w.spawn(world, w.collectives_case,
                          tmp_path_factory.mktemp(f"col{world}"))


def test_world_of_one_is_the_identity():
    assert not parallel.active() and parallel.world() == 1
    x = w.ragged_rows(2)
    assert col.gather_array(x) is x
    assert col.gather_list(["a", 1]) == ["a", 1]
    assert col.sum_across_hosts(x) is x
    t = torch.ones(2, requires_grad=True)
    assert col.all_gather_with_grad(t) is t
    assert not col.all_gather_detached(t).requires_grad
    assert col.all_reduce_mean(t * 3).tolist() == [3.0, 3.0]


def test_gather_array_ragged(ranks):
    world, outs = ranks
    want = np.concatenate([w.ragged_rows(r) for r in range(world)])
    for out in outs:
        np.testing.assert_array_equal(out["array"], want)
        assert isinstance(out["tensor"], torch.Tensor)
        np.testing.assert_array_equal(out["tensor"].numpy(), want)


def test_gather_list(ranks):
    world, outs = ranks
    want = []
    for r in range(world):
        want += [f"r{r}_{i}" for i in range(r + 2)] + [{"rank": r,
                                                        "name": "é"}]
    for out in outs:
        assert out["list"] == want
        assert out["empty"] == ["only"]


def test_sum_across_hosts_in_chunks(ranks):
    world, outs = ranks
    want = sum(w.sum_rows(r) for r in range(world))
    for out in outs:
        # a few fp32 terms summed in another order
        np.testing.assert_allclose(out["sum"], want, rtol=1e-6, atol=1e-6)


def test_all_gather_with_grad_is_autograd_over_the_concatenation(ranks):
    world, outs = ranks
    xs = [torch.from_numpy(w.grad_inputs(r, world)[0]) for r in range(world)]
    x = torch.cat(xs).requires_grad_(True)
    loss = sum((torch.sin(x) * torch.from_numpy(w.grad_inputs(r, world)[1])
                ).sum() for r in range(world))
    loss.backward()
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["gathered"], x.detach().numpy())
        np.testing.assert_allclose(out["grad"],
                                   x.grad[2 * r:2 * r + 2].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_all_gather_detached_carries_no_gradient(ranks):
    world, outs = ranks
    want = np.concatenate([w.grad_inputs(r, world)[0] * 2
                           for r in range(world)])
    for out in outs:
        gathered, requires_grad, no_fn = out["detached"]
        np.testing.assert_array_equal(gathered, want)
        assert not requires_grad and no_fn
