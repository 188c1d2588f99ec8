"""The comparison that decides a retrieval-evaluation cell's ``correct``.

The program's evaluation (``evaluate_ret``) hands back recalls only; the
benchmark keeps, from the window's last evaluation, what its stages
produced for a sample of clips drawn from the seed: each sampled clip's
condition sequence and pooled condition feature, the whole ITC score
matrix, and the ITM rerank's refined matrix. The reference recomputes
them in fp32 from the same raw inputs and weights: the sampled clips'
features and sequences, every caption's text feature, the ITC scores of
every caption against the sampled clips, and the ITM probability of a
fixed number of (caption, clip) pairs the program reranked, drawn from
the seed (``runners/ret_eval.py`` ``itm_pairs``).

Compared, each by its worst case: a condition sequence's relative
Frobenius gap, a pooled feature's L2 gap (unit vectors), an ITC score's
absolute gap, and an ITM probability's absolute gap; and beside the
last, the ITM probabilities' mean absolute gap over those pairs, which
sound runs hold steadier than the worst pair.
"""

from __future__ import annotations

import torch


def reference_outputs(ref, batch: dict, captions: tuple, itm_batch: dict,
                      itm_cols, chunk: int = 64) -> dict:
    """``batch``: the sampled clips' inputs (on the device); ``captions``:
    every caption's (ids, mask); ``itm_batch``: the inputs of the clips
    whose ITM probabilities are compared, and ``itm_cols`` for each of
    them the caption rows compared."""
    with torch.no_grad():
        f = ref.features(batch)
        ids, mask = captions
        feat_t = torch.cat([ref.text_features(ids[s:s + chunk],
                                              mask[s:s + chunk])
                            for s in range(0, ids.shape[0], chunk)])
        cond_itm = ref.features(itm_batch)["cond"]
        itm = []
        for j, rows in enumerate(itm_cols):
            rows_t = torch.as_tensor(rows, device=ids.device)
            itm.append(ref.itm_prob(cond_itm[j:j + 1], ids[rows_t],
                                    mask[rows_t]).cpu())
    return {"cond": f["cond"], "feat_cond": f["feat_cond"],
            "itc": (feat_t @ f["feat_cond"].T).cpu(), "itm": itm}


def compare(got: dict, ref: dict) -> dict:
    """``got``: the program's sampled ``cond`` and ``feat_cond`` (device
    tensors), ``itc`` (captions x sampled clips) and ``itm`` (one tensor
    of reranked probabilities a compared clip)."""
    cond_gap = max(float((g.float() - r).norm() / r.norm())
                   for g, r in zip(got["cond"], ref["cond"]))
    feat_gap = float((got["feat_cond"].float() - ref["feat_cond"])
                     .norm(dim=-1).max())
    itc_gap = float((torch.as_tensor(got["itc"]).float() - ref["itc"])
                    .abs().max())
    itm = torch.cat([(torch.as_tensor(g).float() - r).abs()
                     for g, r in zip(got["itm"], ref["itm"])])
    return {"cond_seq_gap": cond_gap, "feat_cond_gap": feat_gap,
            "itc_gap": itc_gap, "itm_gap": float(itm.max()),
            "itm_gap_mean": float(itm.mean())}
