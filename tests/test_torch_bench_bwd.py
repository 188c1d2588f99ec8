"""The backward's benchmark script and the build's macro variants, on the
CPU: what of ``vast_tpu_torch/scripts/bench_bwd.py`` runs without a card
(its host tally, its refusal to run without one), and that
``vast_tpu_torch.build`` keeps a variant built with macros apart from the
default build. The measurements themselves run on the card only.
"""

import gc
import hashlib
import os
import types

from vast_tpu_torch import build
from vast_tpu_torch.scripts import bench_bwd


def test_host_tally_times_the_wrappers_entries_and_gc_then_restores():
    entry_calls = []
    fa = types.SimpleNamespace(
        self_attention_tmajor_bwd=lambda x: x + 1,
        flash_attention_bwd=lambda x: x * 2,
        _kernel=lambda symbol: (lambda *a: entry_calls.append(symbol) or 0))
    saved = dict(vars(fa))
    with bench_bwd.HostTally(fa) as tally:
        assert fa.self_attention_tmajor_bwd(1) == 2
        assert fa.flash_attention_bwd(2) == 4
        assert fa._kernel("vast_x")(1, 2) == 0
        assert fa._kernel("vast_x")() == 0
        gc.collect()
    assert vars(fa) == saved                   # every name restored
    assert entry_calls == ["vast_x", "vast_x"]
    got = tally.summary()
    assert {n: got[n]["calls"] for n in ("self_attention_tmajor_bwd",
                                         "flash_attention_bwd", "vast_x",
                                         "gc_gen2")} == {
        "self_attention_tmajor_bwd": 1, "flash_attention_bwd": 1,
        "vast_x": 2, "gc_gen2": 1}
    assert all(v["host_s"] >= 0 and v["us_per_call"] >= 0
               for v in got.values())


def test_refuses_without_a_card(capsys):
    assert bench_bwd.main(["host"]) == 2
    assert "no CUDA GPU" in capsys.readouterr().err


def test_a_macro_variant_builds_apart_from_the_default():
    default = build._target("flash_attention")
    with open(os.path.join(build.CSRC, "flash_attention.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()
                                + " ".join(build.NVCC_FLAGS).encode())
    assert os.path.basename(default) == \
        f"flash_attention-{digest.hexdigest()[:16]}.so"
    variant = build._target("flash_attention", bench_bwd.KD96_OFF)
    assert variant != default
    assert os.path.dirname(variant) == os.path.dirname(default)
    assert build._flags(bench_bwd.KD96_OFF)[-1] == "-DVAST_BWD_KD96=0"
