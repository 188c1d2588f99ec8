"""The ret%tva slice as a whole: the port against vast_tpu at tiny size.

Features from uint8 frames and int16-scale waveforms (preprocessing and
the fbank included), the grouped ITM rerank, R@k, the whole
``evaluate_ret``, and the checkpoint round trip
``convert_vast_checkpoint(from_jax(params)) == params``. Same weights on
both sides (tests/test_torch_models.py ``build_pair``), fp32 on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_vast_config
from tests.test_torch_models import build_pair, raw_batch
from vast_tpu.convert.vast_ckpt import convert_vast_checkpoint
from vast_tpu.evaluation import evaluation_mm as jeval
from vast_tpu_torch.convert.from_jax import from_jax
from vast_tpu_torch.evaluation import evaluation_mm as peval
from vast_tpu_torch.ops import flash_attention as fa

# O(1) features through preprocessing, two encoders and the heads, fp32:
# the packages differ by summation order only (~1e-6 relative measured)
ATOL = RTOL = 3e-5


@pytest.fixture(scope="module")
def pair():
    return build_pair(seed=1)


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_ret_tva_features_match(pair):
    jm, params, pm, batch = pair
    want = jm.apply({"params": params},
                    {k: jnp.asarray(v) for k, v in batch.items()},
                    "ret%tva", compute_loss=False)
    with torch.no_grad():
        got = pm(_tensors(batch), "ret%tva", compute_loss=False)
    for key in ("feat_t", "feat_cond_tva", "condition_feats_tva"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=ATOL, rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_rerank_scores_match(pair, direction):
    jm, params, pm, _ = pair
    rs = np.random.RandomState(2)
    n_text, n_cond = 7, 5
    cond = rs.randn(n_cond, 20, 32).astype(np.float32)
    ids = rs.randint(106, 170, (n_text, 12)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[2, 9:] = 0
    itc = rs.randn(n_text, n_cond).astype(np.float32)
    want = jeval.rerank_scores(jm, params, jnp.asarray(cond), ids, mask,
                               itc, 3, direction, texts_per_seg=2,
                               conds_per_call=2)
    got = peval.rerank_scores(pm, torch.from_numpy(cond), ids, mask, itc, 3,
                              direction, texts_per_seg=2, conds_per_call=2)
    assert np.count_nonzero(got) == np.count_nonzero(np.asarray(want)) > 0
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_compute_metric_ret_equal(direction):
    rs = np.random.RandomState(3)
    ids = [f"v{i}" for i in range(9)]
    ids_txt = [ids[i] for i in rs.randint(0, 9, 23)]
    score = rs.randn(23, 9).astype(np.float32)
    score[4, :3] = score[4, 0]               # exact ties rank stably
    for s in (score, np.round(score, 1)):
        assert peval.compute_metric_ret(s, ids, ids_txt, direction) == \
            jeval.compute_metric_ret(s, ids, ids_txt, direction)


def test_evaluate_ret_matches(pair):
    """The whole retrieval evaluation over two numpy batches; both
    packages must produce identical R@k logs (ITC and ITM rerank)."""
    jm, params, pm, _ = pair
    rs = np.random.RandomState(4)
    batches = []
    for s in range(2):
        b = raw_batch(rs, b=3)
        b["ids"] = [f"clip{s}{i}" for i in range(3)]
        b["ids_txt"] = list(b["ids"])
        batches.append(b)
    run_cfg = {"itm_rerank_num": 2, "ret_bidirection_evaluation": True}
    want = jeval.evaluate_ret(jm, params, ["tva"], batches, run_cfg)
    before = dict(fa.LAUNCHES)
    got = peval.evaluate_ret(pm, ["tva"], batches, run_cfg, device="cpu")
    assert fa.LAUNCHES == before
    assert got == want


def test_checkpoint_round_trip_is_exact(pair):
    _, params, _, _ = pair
    back = convert_vast_checkpoint(from_jax(params), tiny_vast_config())
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]),
                                      np.asarray(leaf), err_msg=str(path))
