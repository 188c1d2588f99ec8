"""GroupedAdam's multi-tensor kernel (``csrc/multi_tensor_adam.cu``)
against its per-tensor plain version on the CPU, on the card.

Marked ``gpu``: they skip where there is no CUDA GPU. On a machine with
one, run them without the JAX test settings (tests/conftest.py):

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_adam_gpu.py

The same parameters and gradients step a model on the card (the kernel)
and its twin on the CPU (the per-tensor loop) over three updates, in
AdamW, Adam and Adamax, with fp32 and bf16 moments (``adam_mu_dtype``,
``adam_nu_dtype``), with clipping above and below the gradient's norm,
over every group, a parameter without a gradient, one of one element,
lengths that are not a multiple of the vector width, a tensor of four
chunks and an unaligned one; every parameter and moment is held to
within two ulps of its dtype, element by element (with clipping both
clip by the card's norm, which is held to the CPU's to 1e-6). The launch
counters are checked each step, and a parameter whose storage moves gets
the kernel's tables built again. A CUDA tensor the kernel cannot take (a
strided or bf16 parameter, fp16 moments) is refused at the first step.
"""

import pytest
import torch
from torch import nn

from test_torch_adam import MODEL_CFG, RUN_CFG, Toy, grads_for, set_grads
from vast_tpu_torch.training import optimizer as optim_mod
from vast_tpu_torch.training.optimizer import build_optimizer

pytestmark = pytest.mark.gpu

CASES = {
    "adamw": {},
    "adam": {"optim": "adam"},
    "adamax": {"optim": "adamax"},
    "adamw_bf16_mu": {"adam_mu_dtype": "bfloat16"},
    "adamw_bf16_nu": {"adam_nu_dtype": "bfloat16"},
    "adamw_bf16_both": {"adam_mu_dtype": "bfloat16",
                        "adam_nu_dtype": "bfloat16"},
    "adam_fp32_nu_dtype": {"optim": "adam", "adam_nu_dtype": "float32"},
    # the gradients' norm is about 45: clipped, then not
    "clip_above_norm": {"clip_grads": True, "grad_norm": 0.5},
    "clip_below_norm": {"clip_grads": True, "grad_norm": 1e4},
}
ULPS = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def ordered(x: torch.Tensor) -> torch.Tensor:
    """fp32 or bf16 values as integers in their order, one a ulp apart."""
    bits, mask = ((torch.int16, 0x7FFF) if x.dtype == torch.bfloat16
                  else (torch.int32, 0x7FFFFFFF))
    i = x.contiguous().view(bits).to(torch.int64)
    return torch.where(i < 0, -(i & mask), i)


def assert_ulps(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    assert got.dtype == want.dtype, what
    ulps = (ordered(got.cpu()) - ordered(want)).abs().max().item()
    assert ulps <= ULPS, f"{what}: {ulps} ulps"


def pair(cuda, run_cfg):
    """(model, optimizer) on the card and its twin on the CPU."""
    out = []
    for device in (cuda, "cpu"):
        model = Toy(torch.Generator().manual_seed(0), device)
        out.append((model, build_optimizer(model, run_cfg, MODEL_CFG,
                                           10)[0]))
    return out


@pytest.fixture
def one_norm(monkeypatch):
    """Both twins clip by the card's norm: the CPU's sums in another
    order, and a norm an ulp apart scales every gradient apart, which
    the moments' cancellations then widen. Returns each step's pair
    (card's norm, the CPU's own)."""
    norms = []
    real = optim_mod.global_norm

    def shared(tensors):
        tensors = list(tensors)
        if tensors[0].is_cuda:
            norms.append([real(tensors)])
            return norms[-1][0]
        norms[-1].append(real(tensors))
        return norms[-1][0].cpu()

    monkeypatch.setattr(optim_mod, "global_norm", shared)
    return norms


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, case, one_norm):
    run_cfg = dict(RUN_CFG, **CASES[case])
    (gm, gopt), (cm, copt) = pair(cuda, run_cfg)
    fused_names = [n for n, _ in gm.named_parameters()]
    assert gm.offset.data_ptr() % 16 == 4
    gen = torch.Generator().manual_seed(1)
    for step in range(3):
        grads = grads_for(cm, gen)
        set_grads(gm, grads)
        set_grads(cm, grads)
        before = optim_mod.LAUNCHES["multi_tensor_adam"]
        assert gopt.step() and copt.step()
        assert gopt.last_counts == {"tensors": len(fused_names),
                                    "launches": 1}
        assert copt.last_counts == {"tensors": 0, "launches": 0}
        assert optim_mod.LAUNCHES["multi_tensor_adam"] == before + 1
        assert gopt._fused.names == fused_names
        assert gopt._fused.plain == []
        for (n, p), q in zip(gm.named_parameters(), cm.parameters()):
            assert_ulps(p.detach(), q.detach(), f"step {step} {n}")
            for key in ("mu", "nu"):
                assert_ulps(getattr(gopt, key)[n], getattr(copt, key)[n],
                            f"step {step} {key} {n}")
    if "clip" in case:
        assert len(one_norm) == 3
        for card, cpu in one_norm:
            torch.testing.assert_close(card.cpu(), cpu, rtol=1e-6, atol=0)
    # the clipped case clips: its moments differ from unclipped ones
    if case == "clip_above_norm":
        assert gopt.mu["proj.weight"].abs().max() < 0.1 * 0.5


def test_moved_parameter_rebuilds_the_tables(cuda):
    (gm, gopt), (cm, copt) = pair(cuda, RUN_CFG)
    gen = torch.Generator().manual_seed(1)
    for step in range(3):
        if step == 1:
            with torch.no_grad():
                gm.proj.weight.data = gm.proj.weight.data.clone()
        grads = grads_for(cm, gen)
        set_grads(gm, grads)
        set_grads(cm, grads)
        gopt.step()
        copt.step()
        assert gopt._fused.param_ptrs[0] == gm.scale.data_ptr()
        assert gm.proj.weight.data_ptr() in gopt._fused.param_ptrs
    for (n, p), q in zip(gm.named_parameters(), cm.parameters()):
        assert_ulps(p.detach(), q.detach(), n)


REFUSED = {
    "strided_param": ({}, lambda m: setattr(m, "strided", nn.Parameter(
        torch.zeros(6, 4, device=m.scale.device).t()))),
    "bf16_param": ({}, lambda m: setattr(m, "bf16", nn.Parameter(
        torch.zeros(5, device=m.scale.device, dtype=torch.bfloat16)))),
    "fp16_moments": ({"adam_mu_dtype": "float16"}, lambda m: None),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refuses_what_the_kernel_cannot_take(cuda, case):
    cfg, add = REFUSED[case]
    model = Toy(torch.Generator().manual_seed(0), cuda)
    add(model)
    opt, _ = build_optimizer(model, dict(RUN_CFG, **cfg), MODEL_CFG, 10)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with pytest.raises(ValueError, match="optimizer's kernel updates"):
        opt.step()
    for n, p in model.named_parameters():
        assert torch.equal(p, before[n]), n
