"""The reference's training steps and the comparison that decides a
training cell's ``correct``.

The reference follows the program's first steps from the same seeded
weights, batches and step generators, in fp32: AdamW written out
(decoupled weight decay, bias-corrected moments, eps 1e-6), VAST's three
learning-rate groups (the vision tower at ``clip_lr`` when it is a CLIP
tower), no decay for LayerNorms and for the biases of linear layers and
convolutions, the warm-up-then-linear schedule.

Compared: every step's ITC and ITM loss (the worst relative gap); the
first step's condition sequence of each clip (the worst relative
Frobenius gap), read from the program's feature cache as the step
computes it; each leaf's first gradient norm (the program's read back
from its optimizer's first moment after one step) and each leaf's
parameter change after the checked steps, each by the worst leaf. A
leaf's gap is ``|norm_program - norm_reference|`` over the larger of
the reference's norm of that leaf and the median leaf's of its group:
the vision tower (which steps at ``clip_lr``), the audio tower, the
BERT text and fusion encoder, and the heads. A fault confined to one
group, such as a wrong learning rate for the vision tower, so shows
against that group's own scale. Leaves whose reference gradient is
under a thousandth of the median leaf's (a key bias under softmax) move
by round-off alone and are left out of both. A leaf of a single element
(the contrastive temperature) is left out of the gradient's: its
gradient is a sum over the batch's similarity matrix that cancels to a
different degree on each seed, so its absolute rounding error is steady
and its relative gap swings with the sum's size; its change, which
Adam normalises, stays compared.
"""

from __future__ import annotations

import statistics

import torch
from torch import nn

EPS = 1e-6
ROUNDOFF = 1e-3


def lr_ratio(update: int, horizon: int, warmup: float) -> float:
    x = update / max(horizon, 1)
    if x < warmup:
        return x / warmup
    return max((x - 1.0) / (warmup - 1.0), 0.0)


def param_groups(model: nn.Module, vision_is_clip: bool) -> dict:
    """name -> (group, decays)."""
    out = {}
    for mod_name, mod in model.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            no_decay = (isinstance(mod, nn.LayerNorm)
                        or p_name == "in_proj_bias"
                        or (p_name == "bias"
                            and isinstance(mod, (nn.Linear, nn.Conv2d))))
            group = ("clip" if vision_is_clip
                     and name.startswith("vision_encoder.") else "basic")
            out[name] = (group, not no_decay)
    return out


class AdamW:
    def __init__(self, model: nn.Module, run_cfg: dict, vision_type: str,
                 horizon: int):
        self.params = dict(model.named_parameters())
        self.groups = param_groups(model, "clip" in vision_type)
        self.b1, self.b2 = run_cfg["betas"]
        self.wd = run_cfg["weight_decay"]
        self.lrs = {"basic": run_cfg["learning_rate"],
                    "clip": run_cfg["clip_lr"]}
        self.warmup = run_cfg["warmup_ratio"]
        self.horizon = horizon
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.k = 0

    @torch.no_grad()
    def step(self):
        self.k += 1
        c1, c2 = 1 - self.b1 ** self.k, 1 - self.b2 ** self.k
        ratio = lr_ratio(self.k, self.horizon, self.warmup)
        for n, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.mu[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.nu[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (self.mu[n] / c1) / ((self.nu[n] / c2).sqrt() + EPS)
            group, decays = self.groups[n]
            if decays:
                u = u + self.wd * p
            p.sub_(self.lrs[group] * ratio * u)
            p.grad = None


def leaf_norms(tensors: dict) -> dict:
    names = sorted(tensors)
    norms = torch.stack([tensors[n].float().norm() for n in names]).cpu()
    return dict(zip(names, norms.tolist()))


def run_reference(model, batches, generators, run_cfg, vision_type,
                  horizon) -> dict:
    """The reference's readings over ``batches`` (one a step, each with
    its step generator): losses, first gradient norms, parameter change
    norms, and each leaf's number of elements."""
    opt = AdamW(model, run_cfg, vision_type, horizon)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses, grads, cond = [], None, None
    for i, (batch, gen) in enumerate(zip(batches, generators)):
        out = model.ret_losses(batch, gen)
        sum(out.values()).backward()
        losses.append({k: float(v.detach()) for k, v in out.items()})
        if i == 0:
            cond = model.last_cond
            grads = leaf_norms({n: (p.grad if p.grad is not None
                                    else torch.zeros_like(p))
                                for n, p in model.named_parameters()})
        opt.step()
    change = leaf_norms({n: p.detach() - start[n]
                         for n, p in model.named_parameters()})
    return {"losses": losses, "grad_norms": grads, "change_norms": change,
            "cond": cond,
            "numel": {n: p.numel() for n, p in model.named_parameters()}}


def cond_gap(got, ref) -> float:
    """The worst clip's relative gap of the first step's condition
    sequence (vision, audio and subtitle tokens in the fusion space)."""
    return max(float((g.float() - r).norm() / r.norm())
               for g, r in zip(got, ref))


GROUPS = (("vision", ("vision_encoder.",)),
          ("audio", ("audio_encoder.", "audio_embeddings.")),
          ("text", ("multimodal_encoder.",)))


def group_of(name: str) -> str:
    """The leaf's group: a tower, or the heads."""
    for group, prefixes in GROUPS:
        if name.startswith(prefixes):
            return group
    return "heads"


def leaf_gaps(got: dict, ref: dict, keep) -> dict:
    """name -> the leaf's gap, against the larger of its reference norm
    and its group's median leaf's."""
    by_group = {}
    for n in keep:
        by_group.setdefault(group_of(n), []).append(ref[n])
    med = {g: statistics.median(v) for g, v in by_group.items()}
    return {n: abs(got[n] - ref[n]) / max(ref[n], med[group_of(n)])
            for n in keep}


def compared_leaves(ref: dict) -> tuple[list, list]:
    """(leaves of the gradient's number, leaves of the change's): both
    without the round-off leaves, the gradient's also without leaves of
    one element."""
    med = statistics.median(ref["grad_norms"].values())
    keep = [n for n, v in ref["grad_norms"].items() if v >= ROUNDOFF * med]
    return [n for n in keep if ref["numel"][n] > 1], keep


def compare(got: dict, ref: dict) -> dict:
    """The compared numbers of a training cell: the worst step's loss
    gap, the worst clip's condition-sequence gap, and the worst leaf's
    gaps of the first gradient's and of the change's norms."""
    loss_gap = max(abs(g[k] - r[k]) / abs(r[k])
                   for g, r in zip(got["losses"], ref["losses"]) for k in r)
    grad_keep, change_keep = compared_leaves(ref)
    return {"loss_gap": loss_gap,
            "cond_seq_gap": cond_gap(got["cond"], ref["cond"]),
            "grad_norm_gap": max(leaf_gaps(
                got["grad_norms"], ref["grad_norms"], grad_keep).values()),
            "change_norm_gap": max(leaf_gaps(
                got["change_norms"], ref["change_norms"],
                change_keep).values())}


def worst_by_group(got: dict, ref: dict) -> dict:
    """Each group's worst leaf of both norms, (name, gap), and each leaf
    of one element's gradient, (name, gap, reference norm, absolute
    gap): printed beside the compared numbers."""
    grad_keep, change_keep = compared_leaves(ref)
    out = {}
    for kind, keep in (("grad", grad_keep), ("change", change_keep)):
        gaps = leaf_gaps(got[f"{kind}_norms"], ref[f"{kind}_norms"], keep)
        for n, v in gaps.items():
            key = f"{kind}.{group_of(n)}"
            if key not in out or v > out[key][1]:
                out[key] = (n, v)
    g, r = got["grad_norms"], ref["grad_norms"]
    for n in r:
        if ref["numel"][n] == 1:
            out[f"grad.scalar.{n}"] = (n, abs(g[n] - r[n]) / r[n], r[n],
                                       abs(g[n] - r[n]))
    return out
