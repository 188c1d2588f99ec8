"""Ranks of the port's data-parallel CPU tests (imports torch, not JAX).

``spawn(world, case, tmp, *args)`` starts ``world`` processes with the
``spawn`` method; each joins a gloo group through a ``file://`` rendezvous
under ``tmp`` (no port), sets ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK``
as ``torchrun`` would, runs ``case(rank, world, *args)`` and saves what
it returns; ``spawn`` returns the ranks' results in rank order. An
exception in a rank fails the spawn.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def spawn(world: int, case, tmp, *args) -> list:
    import torch.multiprocessing as mp

    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    init = os.path.join(tmp, f"rendezvous_{case.__name__}_{world}")
    mp.start_processes(_rank_main, args=(world, init, case.__name__, args,
                                         tmp),
                       nprocs=world, start_method="spawn", join=True)
    return [torch.load(os.path.join(tmp, f"{case.__name__}_{world}_{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rank_main(rank, world, init, name, args, tmp):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    from vast_tpu_torch import parallel

    parallel.init_distributed("cpu", init_method=f"file://{init}")
    try:
        out = globals()[name](rank, world, *args)
        torch.save(out, os.path.join(tmp, f"{name}_{world}_{rank}.pt"))
    finally:
        parallel.destroy()


# ------------------------------------------------------------ collectives

def ragged_rows(rank):
    """Rank ``rank``'s rows for the ragged gathers: rank + 1 of them."""
    rs = np.random.RandomState(rank)
    return rs.randn(rank + 1, 3).astype(np.float32)


def sum_rows(rank):
    return np.random.RandomState(10 + rank).randn(7, 5).astype(np.float32)


def grad_inputs(rank, world):
    """(this rank's rows, the weights of its loss over all rows)."""
    rs = np.random.RandomState(20 + rank)
    return (rs.randn(2, 3).astype(np.float32),
            rs.randn(2 * world, 3).astype(np.float32))


def collectives_case(rank, world):
    from vast_tpu_torch.parallel import collectives as col

    out = {"array": col.gather_array(ragged_rows(rank)),
           "tensor": col.gather_array(torch.from_numpy(ragged_rows(rank))),
           "list": col.gather_list([f"r{rank}_{i}" for i in range(rank + 2)]
                                   + [{"rank": rank, "name": "é"}]),
           "empty": col.gather_list([] if rank else ["only"])}
    col.SUM_CHUNK_BYTES = 2 * 5 * 4          # two rows a call: four calls
    out["sum"] = col.sum_across_hosts(sum_rows(rank))
    x, w = (torch.from_numpy(a) for a in grad_inputs(rank, world))
    x.requires_grad_(True)
    y = col.all_gather_with_grad(x)
    (torch.sin(y) * w).sum().backward()
    out["gathered"] = y.detach().numpy()
    out["grad"] = x.grad.numpy()
    z = torch.from_numpy(grad_inputs(rank, world)[0]).requires_grad_(True)
    d = col.all_gather_detached(z * 2)
    out["detached"] = (d.numpy(), d.requires_grad, d.grad_fn is None)
    return out


# ------------------------------------------------------------------ DDP

def _shard(batch, rank, world):
    """This rank's rows of a global numpy batch; the injected ITM
    negatives' (n_subtasks, B) columns alike (indices into the global
    batch)."""
    out = {}
    for k, v in batch.items():
        if k.startswith("itm_neg_"):
            b = v.shape[1] // world
            out[k] = v[:, rank * b:(rank + 1) * b]
        else:
            b = v.shape[0] // world
            out[k] = v[rank * b:(rank + 1) * b]
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in out.items()}


def _model(cfg, state):
    from vast_tpu_torch.models.vast import VASTModel

    model = VASTModel(cfg, device="cpu")
    model.load_state_dict(state)
    return model


def train_steps(model, batches, task, run_cfg, ddp=None, rank=0, world=1):
    """``make_train_step`` over ``batches`` (global numpy batches, each
    cut to this rank's rows): the metrics of every step, the gradients
    left after the last, the parameters and the optimizer's running
    mean."""
    from vast_tpu_torch.training.optimizer import build_optimizer
    from vast_tpu_torch.training.pipeline import step_generator
    from vast_tpu_torch.training.step import (create_train_state,
                                              make_train_step)

    opt, _ = build_optimizer(model, run_cfg, {}, 20)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, task,
                           **({} if ddp is None else {"ddp": ddp}))
    metrics = []
    for i, batch in enumerate(batches):
        state, m = step(state, _shard(batch, rank, world),
                        step_generator(0, i, rank))
        metrics.append({k: v.item() for k, v in m.items()})
    named = dict(model.named_parameters())
    return {"metrics": metrics,
            "grads": {n: None if p.grad is None else p.grad.numpy().copy()
                      for n, p in named.items()},
            "params": {n: p.detach().numpy().copy()
                       for n, p in named.items()},
            "acc": None if opt.acc is None else
            {n: a.numpy().copy() for n, a in opt.acc.items()},
            "mini_step": opt.mini_step, "count": opt.count}


def ddp_case(rank, world, cfg, state, runs):
    """``runs``: {name: (task, [global batches], run_cfg)}, each from
    fresh weights ``state`` through ``data_parallel``."""
    from vast_tpu_torch.training.step import data_parallel

    out = {}
    for name, (task, batches, run_cfg) in runs.items():
        model = _model(cfg, state)
        out[name] = train_steps(model, batches, task, run_cfg,
                                data_parallel(model), rank, world)
    return out


# ------------------------------------------------------------ evaluation

class ArrayDataset:
    """Clips of numpy arrays, a caption each; ``ids`` and ``ids_txt`` in
    each batch, as the annotation datasets collate them."""

    d_cfg: dict = {}           # no vision_transforms: 'none'

    def __init__(self, arrays):
        self.arrays = arrays

    def __len__(self):
        return len(next(iter(self.arrays.values())))

    def __getitem__(self, i):
        return i

    def collate(self, idx):
        out = {k: v[idx] for k, v in self.arrays.items()}
        out["ids"] = [f"clip{i}" for i in idx]
        out["ids_txt"] = list(out["ids"])
        return out


@contextlib.contextmanager
def recorded_scores(calls):
    """Each ``compute_metric_ret`` call's (score, ids, ids_txt)."""
    from vast_tpu_torch.evaluation import evaluation_mm as em

    real = em.compute_metric_ret

    def record(score, ids, ids_txt, direction="forward"):
        calls.append((np.array(score), list(ids), list(ids_txt), direction))
        return real(score, ids, ids_txt, direction)

    em.compute_metric_ret = record
    try:
        yield calls
    finally:
        em.compute_metric_ret = real


def eval_case(rank, world, cfg, state, arrays, batch_size, out_dir):
    """``evaluate_ret`` (ret%tvas, top 3) and ``evaluate_cap`` (cap%tvas)
    over this rank's shard of ``arrays`` at ``batch_size // world``; and
    every rank's ``meta_loader_draws``, gathered."""
    from vast_tpu_torch.data.loader import BatchLoader
    from vast_tpu_torch.data.tokenizer import tiny_tokenizer
    from vast_tpu_torch.evaluation import evaluation_mm as em
    from vast_tpu_torch.parallel.collectives import gather_list

    model = _model(cfg, state)
    loader = BatchLoader(ArrayDataset(arrays), max(batch_size // world, 1),
                         shuffle=False, drop_last=False, num_workers=1,
                         host_id=rank, num_hosts=world)
    run_cfg = {"itm_rerank_num": 3, "ret_bidirection_evaluation": True,
               "output_dir": out_dir, "seed": 5}
    with recorded_scores([]) as calls:
        ret = em.evaluate_ret(model, ["tvas"], loader, run_cfg,
                              device="cpu")
    cap = em.evaluate_cap(model, tiny_tokenizer(), ["tvas"], loader,
                          run_cfg, 0, "synth", device="cpu")
    return {"ret": ret, "scores": calls, "cap": cap,
            "padded_tail": loader.padded_tail,
            "draws": gather_list([meta_loader_draws()])}


def meta_loader_draws():
    """The first 24 task draws of a MetaLoader over three sets (ratios
    3 : 1 : 2, accumulation 2)."""
    from vast_tpu_torch.data.loader import MetaLoader

    loaders = {name: ([f"{name}{i}" for i in range(5)], ratio)
               for name, ratio in (("a", 3), ("b", 1), ("c", 2))}
    draws = []
    for name, _ in MetaLoader(loaders, accum_steps=2, seed=4):
        draws.append(name)
        if len(draws) == 24:
            return draws


# -------------------------------------------------------------------- CLI

def cli_case(rank, world, cfg_path, out_dir):
    """The port's CLI in this rank: 2 train steps (an evaluation and a
    save after each), then ``--mode testing`` from the saved step; how
    many files each rank's saver wrote."""
    from vast_tpu_torch import run
    from vast_tpu_torch.training import saver

    writes = []
    real = saver._save

    def counted(obj, path):
        writes.append(os.path.basename(path))
        real(obj, path)

    saver._save = counted
    try:
        state, logged = run.main(["--config", cfg_path, "--output_dir",
                                  out_dir, "--num_train_steps", "2",
                                  "--device", "cpu"])
        ckpt = os.path.join(out_dir, "ckpt", "model_step_2.pt")
        tested = run.main(["--config", cfg_path, "--output_dir",
                           out_dir + "_test", "--mode", "testing",
                           "--checkpoint", ckpt, "--device", "cpu"])
    finally:
        saver._save = real
    return {"logged": {k: dict(v) for k, v in logged.items()},
            "tested": tested, "writes": writes, "step": state.step}
