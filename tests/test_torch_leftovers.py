"""The last pieces of vast_tpu ported: the offload remat policies,
``EvaVitConfig.gelu_approx`` and ``data/offline_extract.py``.

* ``attn_offload`` / ``dots_offload``: a tiny model's ret%tvas losses
  and every gradient equal to those of ``attn`` / ``dots`` (on the CPU
  the cached tensors stay in host memory; the card's check that they
  leave the device is ``chip_smoke.py``'s ``remat_offload``);
* ``gelu_approx`` True / False: the EVA tower's output against
  vast_tpu's, fp32 (where None would pick the exact GELU);
* the ffmpeg command lines against vast_tpu's, case for case with
  ``tests/test_offline_extract.py``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import TINY_EVA, tiny_vast_config
from tests.test_offline_extract import make_fake_ffmpeg
from tests.test_torch_ddp import _global_batch
from tests.test_torch_models import _port_cfg, port_config
from vast_tpu.data import offline_extract as j_extract
from vast_tpu.models import eva_vit as j_eva
from vast_tpu_torch.convert import from_jax as convert
from vast_tpu_torch.convert.from_jax import init_random_
from vast_tpu_torch.data import offline_extract as extract
from vast_tpu_torch.models import eva_vit
from vast_tpu_torch.models.vast import VASTModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------ offload policies

def _grads(policy):
    """ret%tvas losses and every gradient of the tiny model with every
    tower block checkpointed under ``policy``."""
    cfg = port_config(tiny_vast_config())
    sub = dict(remat=True, remat_policy=policy)
    cfg = dataclasses.replace(
        cfg, vision_cfg=dataclasses.replace(cfg.vision_cfg, **sub),
        audio_cfg=dataclasses.replace(cfg.audio_cfg, **sub),
        bert_cfg=dataclasses.replace(cfg.bert_cfg, **sub))
    model = VASTModel(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(5))
    batch = {k: torch.from_numpy(v) for k, v in
             _global_batch(np.random.RandomState(3)).items()}
    out = model(batch, "ret%tvas", compute_loss=True,
                generator=torch.Generator().manual_seed(0))
    sum(out.values()).backward()
    return ({k: float(v.detach()) for k, v in out.items()},
            {n: p.grad for n, p in model.named_parameters()})


@pytest.mark.parametrize("policy", ["attn", "dots"])
def test_offload_policy_gradients_equal_its_policy(policy):
    losses, grads = _grads(policy)
    got_losses, got = _grads(f"{policy}_offload")
    assert got_losses == losses
    reached = 0
    for n, g in grads.items():
        assert (g is None) == (got[n] is None), n
        if g is not None:
            reached += 1
            assert torch.equal(got[n], g), n
    assert reached > 100


# ------------------------------------------------------------ gelu_approx

@pytest.mark.parametrize("approx", [True, False])
def test_gelu_approx_matches_vast_tpu_eva(approx):
    """fp32: True forces the tanh GELU, False the exact one, in both."""
    jc = dataclasses.replace(TINY_EVA, gelu_approx=approx)
    rs = np.random.RandomState(7)
    px = rs.randn(2, 32, 32, 3).astype(np.float32)
    jm = j_eva.EvaVisionTransformer(jc)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1),
                              jnp.asarray(px))["params"]
    # wide activations, so that tanh and erf differ well above the
    # tolerance
    params = jax.tree.map(lambda p: np.asarray(p) * 8.0, params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(px)))
    pm = eva_vit.EvaVisionTransformer(_port_cfg(eva_vit.EvaVitConfig, jc),
                                      "cpu")
    sd = {}
    convert._eva(sd, "", params)
    pm.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    assert pm.cfg.gelu_approx is approx
    with torch.no_grad():
        got = pm(torch.from_numpy(px)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the MLP takes the GELU asked for, not the other
    mlp = pm.blocks[0].mlp
    x = torch.from_numpy(rs.randn(4, 32).astype(np.float32)) * 4
    with torch.no_grad():
        h = mlp.fc1(x)
        for kind, ok in (("tanh", approx), ("none", not approx)):
            ref = mlp.fc2(torch.nn.functional.gelu(h, approximate=kind))
            assert torch.equal(mlp(x), ref) == ok, kind


# -------------------------------------------------------- offline_extract

def _calls(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


@pytest.mark.parametrize("case", ["commands", "end_to_end", "warns",
                                  "cli_requires_ffmpeg"])
def test_offline_extract_matches_vast_tpu(case, tmp_path, capsys):
    """tests/test_offline_extract.py's cases, the port against
    vast_tpu."""
    if case == "commands":
        for args in (("/v/x.mp4", "/o/frames_fps1/x", 1.0),
                     ("/v/y.webm", "/o/f", 2.5, "/bin/ff")):
            assert extract.frame_cmd(*args) == j_extract.frame_cmd(*args)
        for args in (("/v/x.mp4", "/o/audios/x.wav", 22050),
                     ("/v/y.mov", "/o/a/y.wav", 16000, "/bin/ff")):
            assert extract.audio_cmd(*args) == j_extract.audio_cmd(*args)
        assert extract.VIDEO_EXTS == j_extract.VIDEO_EXTS
    elif case == "end_to_end":
        vid_dir = tmp_path / "vids"
        vid_dir.mkdir()
        for name in ("a.mp4", "b.mkv", "notavideo.txt"):
            (vid_dir / name).write_bytes(b"xx")
        ffmpeg, log = make_fake_ffmpeg(tmp_path)
        outs = {}
        for name, mod in (("port", extract), ("vast_tpu", j_extract)):
            out_dir = tmp_path / name
            assert mod.extract_all(str(vid_dir), str(out_dir), workers=1,
                                   fps=2.0, sr=16000,
                                   ffmpeg=ffmpeg) == (2, 0)
            calls = _calls(log)
            log.unlink()
            outs[name] = ([[a.replace(str(out_dir), "OUT") for a in c]
                           for c in calls],
                          sorted(str(p.relative_to(out_dir))
                                 for p in out_dir.rglob("*")))
        assert outs["port"] == outs["vast_tpu"]
        assert len(outs["port"][0]) == 4      # 2 videos x (frames, audio)
        assert "frames_fps2/a/frame_0001.jpg" in outs["port"][1]
    elif case == "warns":
        assert extract.extract_one("/does/not/exist.mp4", str(tmp_path),
                                   ffmpeg="/no/such/ffmpeg") is False
        assert "warn:" in capsys.readouterr().err
    else:
        r = subprocess.run(
            [sys.executable, "-m", "vast_tpu_torch.data.offline_extract",
             str(tmp_path), str(tmp_path), "--ffmpeg", "/no/such/bin"],
            capture_output=True, text=True, cwd=REPO)
        assert r.returncode == 2
        assert "not found" in r.stderr
