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


# ------------------------------------------------------ parameter sharding

def _data_rows(batch, mesh):
    """This rank's rows of a global numpy batch: its index in the mesh's
    data group (the ranks of a tp group take the same rows)."""
    from vast_tpu_torch import parallel

    group = parallel.data_group(mesh)
    return _shard(batch, parallel.group_rank(group),
                  parallel.group_size(group))


def sharded_state(cfg, state, mesh, flags, run_cfg, min_size=0):
    """A fresh model from ``state``, its optimizer, sharded on ``mesh``."""
    from vast_tpu_torch.training.optimizer import build_optimizer
    from vast_tpu_torch.training.step import create_train_state, shard_state

    model = _model(cfg, state)
    opt, _ = build_optimizer(model, run_cfg, {}, 20)
    return shard_state(mesh, create_train_state(model, opt),
                       fsdp=flags.get("fsdp", False),
                       tp=flags.get("tp", False), min_size=min_size)


def whole_tensors(st, tensors: dict) -> dict:
    """{name: whole numpy array} of ``tensors`` (this rank's parts),
    gathered; every rank calls it."""
    sh = st.sharding
    return {n: None if t is None else
            (t if sh is None else sh.full(n, t)).detach().numpy().copy()
            for n, t in tensors.items()}


def shard_step_case(rank, world, cfg, state, mesh_dims, flags, runs):
    """``runs``: {name: (task, [global batches], run_cfg)}; each from
    fresh weights ``state`` sharded on ``create_mesh(**mesh_dims)`` by
    ``flags`` (min_size 0): the metrics of every step, the whole
    gradients after the last, the whole parameters, each parameter's
    local and whole shape and its moments' local shape."""
    from vast_tpu_torch import parallel
    from vast_tpu_torch.training.pipeline import step_generator
    from vast_tpu_torch.training.step import make_train_step

    mesh = parallel.create_mesh(**mesh_dims)
    data_rank = parallel.group_rank(parallel.data_group(mesh))
    out = {}
    for name, (task, batches, run_cfg) in runs.items():
        st = sharded_state(cfg, state, mesh, flags, run_cfg)
        step = make_train_step(st.model, st.opt, task,
                               sharding=st.sharding)
        metrics = []
        for i, batch in enumerate(batches):
            st, m = step(st, _data_rows(batch, mesh),
                         step_generator(0, i, data_rank))
            metrics.append({k: v.item() for k, v in m.items()})
        named = dict(st.model.named_parameters())
        out[name] = {
            "metrics": metrics,
            "grads": whole_tensors(st, {n: p.grad for n, p in named.items()}),
            "params": whole_tensors(st, {n: p.detach()
                                         for n, p in named.items()}),
            "shapes": {n: (tuple(p.shape), tuple(st.opt.mu[n].shape),
                           tuple(st.opt.nu[n].shape))
                       for n, p in named.items()},
            "plan": st.sharding.plans if st.sharding else None}
    return out


def resume_save_case(rank, world, cfg, ckpt_root, out_root, mesh_dims,
                     flags, run_cfg):
    """A fresh model (other weights) sharded on the mesh; the newest
    checkpoint under ``ckpt_root`` restored into it (its whole moments
    and step returned), then saved again under ``out_root``."""
    from vast_tpu_torch import parallel
    from vast_tpu_torch.convert.from_jax import init_random_
    from vast_tpu_torch.models.vast import VASTModel
    from vast_tpu_torch.training.saver import ModelSaver

    mesh = parallel.create_mesh(**mesh_dims)
    other = VASTModel(cfg, device="cpu")
    init_random_(other, torch.Generator().manual_seed(99))
    st = sharded_state(cfg, other.state_dict(), mesh, flags, run_cfg)
    st, start = ModelSaver(ckpt_root).restore_latest(st)
    opt = st.opt.state_dict()
    ModelSaver(out_root).save(st, start)
    return {"start": start, "step": st.step, "count": opt["count"],
            "mu": {n: t.numpy() for n, t in opt["mu"].items()},
            "nu": {n: t.numpy() for n, t in opt["nu"].items()}}


def fused_eval_case(rank, world, cfg, state, batch, mesh_dims, flags, task,
                    run_cfg):
    """Under inference: the condition features (EVA01's fused qkv read
    through ``FusedCache``), one train step, the features again."""
    from vast_tpu_torch import parallel
    from vast_tpu_torch.training.step import make_train_step

    mesh = parallel.create_mesh(**mesh_dims)
    st = sharded_state(cfg, state, mesh, flags, run_cfg)
    rows = _data_rows(batch, mesh)

    def feats():
        with torch.inference_mode():
            out = st.model.condition_features(rows, ("tvas",))
        return {k: v.numpy().copy() for k, v in out.items()}

    before = feats()
    before_again = feats()
    step = make_train_step(st.model, st.opt, task, sharding=st.sharding)
    st, _ = step(st, rows, torch.Generator().manual_seed(0))
    group = parallel.data_group(mesh)
    named = dict(st.model.named_parameters())
    return {"before": before, "before_again": before_again,
            "after": feats(), "rows": (parallel.group_rank(group),
                                       parallel.group_size(group)),
            "params_after": whole_tensors(st, {n: p.detach()
                                               for n, p in named.items()})}


def norm_case(rank, world, cfg, state, batch, mesh_dims, flags, task,
              run_cfg):
    """One step with clipping: the whole gradient's norm as the sharded
    optimizer computed it (before clipping), and the whole parameters
    after the step."""
    from vast_tpu_torch import parallel
    from vast_tpu_torch.training.pipeline import step_generator
    from vast_tpu_torch.training.step import make_train_step

    mesh = parallel.create_mesh(**mesh_dims)
    st = sharded_state(cfg, state, mesh, flags, run_cfg)
    data_rank = parallel.group_rank(parallel.data_group(mesh))
    step = make_train_step(st.model, st.opt, task, sharding=st.sharding)
    norms, real = [], st.sharding.global_norm
    st.sharding.global_norm = lambda g: norms.append(real(g)) or norms[-1]
    st, _ = step(st, _data_rows(batch, mesh), step_generator(0, 0,
                                                              data_rank))
    named = dict(st.model.named_parameters())
    return {"norm": [float(n) for n in norms],
            "params": whole_tensors(st, {n: p.detach()
                                         for n, p in named.items()})}


def shard_eval_case(rank, world, cfg, state, arrays, batch_size, out_dir,
                    mesh_dims, flags):
    """``evaluate_ret`` (ret%tvas, top 3) and ``evaluate_cap`` over this
    rank's data shard of ``arrays`` with the parameters sharded."""
    from vast_tpu_torch import parallel
    from vast_tpu_torch.data.loader import BatchLoader
    from vast_tpu_torch.data.tokenizer import tiny_tokenizer
    from vast_tpu_torch.evaluation import evaluation_mm as em

    mesh = parallel.create_mesh(**mesh_dims)
    st = sharded_state(cfg, state, mesh, flags, {})
    group = parallel.data_group(mesh)
    drank, dsize = parallel.group_rank(group), parallel.group_size(group)
    loader = BatchLoader(ArrayDataset(arrays), max(batch_size // dsize, 1),
                         shuffle=False, drop_last=False, num_workers=1,
                         host_id=drank, num_hosts=dsize)
    run_cfg = {"itm_rerank_num": 3, "ret_bidirection_evaluation": True,
               "output_dir": out_dir, "seed": 5}
    with recorded_scores([]) as calls:
        ret = em.evaluate_ret(st.model, ["tvas"], loader, run_cfg,
                              device="cpu", mesh=mesh)
    cap = em.evaluate_cap(st.model, tiny_tokenizer(), ["tvas"], loader,
                          run_cfg, 0, "synth", device="cpu", mesh=mesh)
    return {"ret": ret, "scores": calls, "cap": cap}


def towers_tp_case(rank, world, towers, mesh_dims):
    """Towers split over tp (min_size 0), one after another on the same
    mesh: ``towers`` {name: (module, class name, config, constructor
    keywords, state dict, input, weights)}; each one's output, the whole
    gradient of ``sum(output * weights)``, its split and partial
    parameters and the heads of each attention module on this rank."""
    import importlib

    from vast_tpu_torch import parallel
    from vast_tpu_torch.training.optimizer import GroupedAdam
    from vast_tpu_torch.training.step import create_train_state, shard_state

    mesh = parallel.create_mesh(**mesh_dims)
    out = {}
    for name, (module, cls, cfg, kw, state, x, weights) in towers.items():
        tower = getattr(importlib.import_module(module), cls)(
            cfg, device="cpu", **kw)
        tower.load_state_dict(state)
        st = shard_state(mesh, create_train_state(
            tower, GroupedAdam(tower, {}, {}, 1)), tp=True, min_size=0)
        y = tower(torch.from_numpy(x))
        (y * torch.from_numpy(weights)).sum().backward()
        st.sharding.reduce_grads()
        named = dict(tower.named_parameters())
        plans = st.sharding.plans
        out[name] = {
            "out": y.detach().numpy(),
            "grads": whole_tensors(st, {n: p.grad
                                        for n, p in named.items()}),
            "split": sorted(n for n, pl in plans.items()
                            if pl.tp_dim is not None),
            "partial": sorted(n for n, pl in plans.items() if pl.tp_partial),
            "heads": [m.heads for m in tower.modules()
                      if hasattr(m, "tp_linears") and hasattr(m, "heads")]}
    return out


def several(rank, world, cases):
    """``{key: case(rank, world, *args)}`` for ``cases`` ``{key: (case
    name, args)}``, in order, in one group: one spawn for them all."""
    return {key: globals()[name](rank, world, *args)
            for key, (name, args) in cases.items()}


def cli_flags_case(rank, world, cfg_paths, out_root):
    """The CLI in this rank once per config of ``cfg_paths`` ({name:
    task config}): 2 train steps into ``<out_root>/<name>``."""
    from vast_tpu_torch import run

    out = {}
    for name, path in cfg_paths.items():
        state, logged = run.main(["--config", path, "--output_dir",
                                  os.path.join(out_root, name),
                                  "--num_train_steps", "2", "--device",
                                  "cpu"])
        out[name] = {"logged": {k: dict(v) for k, v in logged.items()},
                     "step": state.step,
                     "sharded": state.sharding is not None}
    return out


def pipeline_mesh_case(rank, world, cfg_path, out_dir, mesh_dims):
    """``pipeline.train`` on ``create_mesh(**mesh_dims)`` (the task
    config sets ``run_cfg.fsdp`` / ``tp``; every parameter split that
    can be: min_size 0), then the saved checkpoint in an unsharded model
    tested on the same mesh: what ``chip_smoke.py``'s ``shard_train``
    runs on the card."""
    from vast_tpu_torch import parallel, run
    from vast_tpu_torch.parallel import mesh as pmesh
    from vast_tpu_torch.training import pipeline

    pmesh.MIN_SHARD_SIZE = 0
    mesh = parallel.create_mesh(**mesh_dims)
    opts = run.get_args(["--config", cfg_path, "--output_dir", out_dir])
    pipeline.initialize(opts)
    tok = pipeline.build_tokenizer(opts)
    model = pipeline.build_model(opts, "cpu", tok)
    train_loader = pipeline.create_train_dataloaders(opts, tok, mesh)
    val = pipeline.create_val_dataloaders(opts, tok, mesh)
    steps = opts.run_cfg.num_train_steps
    opts.run_cfg.valid_steps = steps + 2       # one evaluation, at the end
    state, logged = pipeline.train(model, opts, tok, train_loader, val,
                                   mesh=mesh)
    out = {"sharded": state.sharding is not None,
           "split": sum(not p.whole for p in state.sharding.plans.values()),
           "logged": {k: dict(v) for k, v in logged.items()}}
    ckpt = os.path.join(out_dir, "ckpt", f"model_step_{steps}.pt")
    whole = state.sharding.full_state_dict(keep=rank == 0)
    if rank == 0:
        saved = torch.load(ckpt, weights_only=True)
        out["files"] = sorted(os.listdir(os.path.dirname(ckpt)))
        out["differs"] = [k for k in saved if k not in whole
                          or not torch.equal(saved[k], whole[k])]
        out["keys_equal"] = list(saved) == list(whole)
    parallel.barrier()
    plain = pipeline.build_model(opts, "cpu", tok)
    reload = plain.load_state_dict(torch.load(ckpt, weights_only=True),
                                   strict=False)
    out["reload"] = (reload.missing_keys, reload.unexpected_keys)
    out["tested"] = pipeline.test(plain, opts, tok, val, mesh=mesh)
    out["steps"] = steps
    return out
