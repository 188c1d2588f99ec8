"""Tiny widths of the benchmark's configurations and mixes, for CPU
tests: the same code paths as the cells at a size a test run holds."""

import time

import torch

from benchmark import harness, spec

EVA = {"image_size": 28, "patch_size": 14, "width": 64, "layers": 2,
       "head_width": 32, "mlp_ratio": 2.0, "ln_eps": 1e-6}
CLIP = {"image_size": 28, "patch_size": 14, "width": 64, "layers": 2,
        "heads": 2, "ln_eps": 1e-5}
BEATS = {"input_patch_size": 16, "embed_dim": 32, "encoder_layers": 2,
         "encoder_embed_dim": 64, "encoder_ffn_embed_dim": 128,
         "encoder_attention_heads": 2, "conv_pos": 16, "conv_pos_groups": 4,
         "num_buckets": 32, "max_distance": 80, "ln_eps": 1e-5}
AST = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 2,
       "intermediate_size": 128, "audio_melbins": 32,
       "audio_target_length": 64, "patch_size": 16, "ln_eps": 1e-12}
BERT = {"vocab_size": 1200, "hidden_size": 64, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 128,
        "max_position_embeddings": 128}


def cell(name: str) -> dict:
    c = spec.load_cell(name)
    cfg = c["config_spec"]
    eva = cfg["vision_encoder_type"].startswith("evaclip")
    cfg["vision"] = dict(EVA if eva else CLIP)
    cfg["audio"] = dict(BEATS if cfg["audio_encoder_type"] == "beats"
                        else AST)
    cfg["bert"] = dict(cfg["bert"], **BERT)
    cfg.update(vision_resolution=28, audio_melbins=32,
               audio_target_length=64)
    t = c["traffic_spec"]
    t.update(audio_samples=400 + 63 * 160, batch_size=4, pool_batches=2)
    if "clips" in t:
        t.update(clips=12, batch_size=8, frames=2, checked_clips=3,
                 itm_rerank_num=4, itm_checked_clips=3, itm_checked_texts=12)
    return c


def ctx(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.05):
    return harness.Ctx(cell=cell(name), seed=seed, seconds=seconds,
                       trace=False, device=torch.device("cpu"),
                       t_start=time.perf_counter())


def correct(out: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in out["checks"].values())
