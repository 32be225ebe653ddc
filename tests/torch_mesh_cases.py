"""The parallel layouts' multi-process cases (not a test module; imports
torch and the port only, never JAX: a spawned worker that imported a test
module would import JAX without tests/conftest.py's CPU setting).

`spawn(fn, world, tmp_dir, *args)` runs `fn(rank, world, *args)` on
`world` CPU processes joined in a gloo process group whose rendezvous is a
FileStore under `tmp_dir` (no TCP port: the suite runs under xdist), and
returns rank 0's result (`start` and `result` do it in two halves, so
that the caller can work meanwhile). The cases:

  * `train_steps`: two train steps of one layout (replicated DDP, FSDP2 or
    the (data, model) DTensor layout) on this rank's slice of a global
    batch with the global batch's injected draws; the metrics of each step
    and the parameters after them, gathered whole;
  * `world2_cases`: DDP, DDP with BatchNorm's statistics left per rank,
    FSDP2; a PredictionTrainer under FSDP2 that restores a sharded
    checkpoint written at world 1, trains and writes its own; and mesh
    plans (`CEMPolicy(mesh=)`) in float32 and int8;
  * `world4_cases`: the 2x2 (data, model) layout and the leaf rule.
"""

from __future__ import annotations

import contextlib
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg as tsvg
from robot_aware_control_tpu_torch.parallel import mesh as pmesh
from robot_aware_control_tpu_torch.training import step as tstep

# the JAX package's sharded-step config (tests/test_multichip.py:_tiny_cfg)
TINY = dict(
    model="svg", g_dim=8, z_dim=2, image_height=16, image_width=16,
    action_dim=5, robot_dim=5, robot_joint_dim=5, n_past=1, n_future=2,
    model_use_mask=True, model_use_robot_state=True,
    reconstruction_loss="dontcare_l1", scheduled_sampling=True,
    compute_dtype="float32", batch_size=8, test_batch_size=8,
)
# the mesh plans: the small int8 test config's shapes (24x32, N = 4)
PLAN = dict(
    model="svg", g_dim=16, z_dim=4, image_width=32, image_height=24,
    action_dim=5, robot_dim=5, robot_joint_dim=5, model_use_mask=True,
    model_use_robot_state=True, reconstruction_loss="dontcare_l1",
    reward_type="dontcare", compute_dtype="float32", horizon=3, opt_iter=1,
    action_candidates=4, topk=2, cem_init_std=0.015,
)


def tiny_batch(B=8, W=3):
    """tests/test_multichip.py:_tiny_batch."""
    rng = np.random.RandomState(0)
    return {
        "images": rng.rand(W, B, 16, 16, 3).astype(np.float32),
        "masks": (rng.rand(W, B, 16, 16, 1) > 0.8).astype(np.float32),
        "states": rng.rand(W, B, 5).astype(np.float32),
        "actions": rng.rand(W - 1, B, 5).astype(np.float32),
    }


def fixed_normal(shape):
    """The injected N(0, 1) stand-in (tests/torch_train_cases.py)."""
    n = int(np.prod(shape))
    return np.sin(np.arange(n) * 0.7 + 0.3).reshape(shape).astype(np.float32)


def tiny_noise(B=8, steps=2, device="cpu"):
    """The global batch's draws of a window: ground truth fed throughout,
    the prior's and the posterior's draws the fixed stand-in of their
    shape (B, 2, 2, 2), as the patched jax.random.normal gives them."""
    eps = torch.tensor(fixed_normal((B, 2, 2, 2)), device=device).expand(
        steps, B, 2, 2, 2)
    return {"use_truth": torch.ones(steps, dtype=torch.bool, device=device),
            "eps_prior": eps, "eps_post": eps}


def train_model(params, bn, cfg, device="cpu"):
    """A training model holding flat JAX-layout trees ({keystr: array})."""
    model = tsvg.SVG(cfg, device, param_dtype=torch.float32)
    model.load_state_dict(convert.state_dict_from_flat(params, bn))
    return model


def trained(cfg: Config, params, bn, layout=None, steps=2, device="cpu"):
    """`steps` train steps of the flat trees `params`, `bn` in `layout`
    (None: one process) on this rank's slice of tiny_batch. Returns
    ([metrics of each step], model, optimizer)."""
    model = train_model(params, bn, cfg, device)
    step, optimizer = tstep.make_train_step(cfg, model, layout)
    batch = tiny_batch(cfg.batch_size)
    if layout is not None:
        batch = pmesh.shard_batch(layout.mesh, batch, axis=layout.data_axis)
    batch = {k: torch.tensor(v, device=device) for k, v in batch.items()}
    out = []
    for _ in range(steps):
        m = step(batch, 1.0, noise=tiny_noise(cfg.batch_size, device=device))
        out.append({k: float(v) for k, v in m.items()})
    return out, model, optimizer


def train_steps(cfg: Config, params, bn, layout=None, steps=2, device="cpu"):
    """`trained`'s metrics and the parameters after the steps (whole, as
    flat JAX-layout trees)."""
    metrics, model, _ = trained(cfg, params, bn, layout, steps, device)
    return metrics, convert.jax_flat_trees(model)[0]


def layout_config(kind: str, model_axis: int = 1, **kw) -> Config:
    return Config(**dict(TINY, param_sharding=kind, model_axis_size=model_axis,
                         **kw))


def layout_steps(kind: str, params, bn, model_axis: int = 1, device="cpu",
                 **kw):
    cfg = layout_config(kind, model_axis, **kw)
    return train_steps(cfg, params, bn, pmesh.Layout(cfg), device=device)


def step_errors(got, want, lr: float) -> dict:
    """The largest differences of two `train_steps` results: step 1's and
    step 2's metrics relative to tests/test_multichip.py's tolerances
    (rtol 2e-4 / atol 1e-5, rtol 5e-3 / atol 1e-4; 1 at the limit), and
    the parameters' largest difference in units of lr (limit 5)."""
    (gm, gp), (wm, wp) = got, want
    tol = ((2e-4, 1e-5), (5e-3, 1e-4))
    metrics = [max(abs(g[k] - w[k]) / (a + r * abs(w[k])) for k in w)
               for g, w, (r, a) in zip(gm, wm, tol)]
    params = max(float(np.abs(gp[k] - v).max()) for k, v in wp.items()) / lr
    return {"step1": metrics[0], "step2": metrics[1], "params_lr": params}


# ------------------------------------------------------------- processes
def _entry(rank, world, store_path, out_path, fn, args_path):
    torch.set_num_threads(1)
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    store = dist.FileStore(store_path, world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    try:
        result = fn(rank, world, *args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def start(fn, world: int, tmp_dir: str, *args):
    """Starts fn(rank, world, *args) on `world` gloo processes and returns
    at once; `result` waits for them. The arguments go through a file: a
    process's start blocks until the one before it has read its arguments
    from the pipe, after its imports."""
    store = os.path.join(tmp_dir, f"store_{fn.__name__}")
    out = os.path.join(tmp_dir, f"result_{fn.__name__}.pkl")
    args_path = os.path.join(tmp_dir, f"args_{fn.__name__}.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    ctx = mp.spawn(_entry, args=(world, store, out, fn, args_path),
                   nprocs=world, join=False)
    return ctx, out


def result(handle):
    """Rank 0's result of `start`'s processes, once all have ended (raises
    what a process raised)."""
    ctx, out = handle
    while not ctx.join():
        pass
    with open(out, "rb") as f:
        return pickle.load(f)


def spawn(fn, world: int, tmp_dir: str, *args):
    """fn(rank, world, *args) on `world` gloo processes; rank 0's result."""
    return result(start(fn, world, tmp_dir, *args))


@contextlib.contextmanager
def world1_mesh(tmp_dir):
    """A one-process gloo group (FileStore under `tmp_dir`) and its "data"
    mesh, for the duration of the block only: a group left behind would
    put later trainers of the same test process into a layout."""
    store = dist.FileStore(os.path.join(str(tmp_dir), "store_world1"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield pmesh.get_mesh(axis="data")
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------------- cases
def world2_cases(rank, world, params, bn, ckpt_in, log_dir):
    out = {"ddp": layout_steps("replicated", params, bn),
           "fsdp": layout_steps("data", params, bn)}
    # BatchNorm on each rank's rows alone: what the sharded step must not do
    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(tstep, "batch_stats_group",
                                     lambda group: contextlib.nullcontext()))
        out["ddp_per_rank_bn"] = layout_steps("replicated", params, bn)
    out["checkpoint"] = checkpoint_case(ckpt_in, log_dir)
    out["plans"] = mesh_plans()
    out["feed"] = feed_case(log_dir)
    out["refusals"] = refusals()
    return out


def feed_case(log_dir):
    """Each rank's share of the data: the synthetic train batch (global 4:
    2 rows, seeded cfg.seed + 1000 x the data index, so the ranks' rows
    differ), and a file list and batch size through the loaders'
    host sharding (data/loader.py)."""
    from robot_aware_control_tpu_torch.data import loader as L
    from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer

    cfg = trainer_config(os.path.join(log_dir, "feed"), param_sharding="data")
    t = PredictionTrainer(cfg, device="cpu")
    train, _ = t._setup_data()
    t.logger.close()
    images = next(iter(train))["images"]
    sums = [None] * dist.get_world_size()
    dist.all_gather_object(sums, float(images.sum()))
    return {"rows": images.shape[1], "rank_sums": sums,
            "files": L._host_shard(list(range(10)), cfg),
            "batch": L._host_batch(8, cfg)}


def refusals():
    """What a layout refuses at world 2: a global batch the data axis does
    not divide, and a model axis the world does not divide."""
    out = {}
    for name, kw in (("batch", dict(batch_size=3)),
                     ("model_axis", dict(param_sharding="model",
                                         model_axis_size=4))):
        try:
            pmesh.Layout(Config(**dict(TINY, **kw)))
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def world4_cases(rank, world, params, bn):
    from torch.distributed.tensor import Replicate, Shard

    out = {"model": layout_steps("model", params, bn, model_axis=2,
                                 mesh_axes=("dp", "tp"))}
    mesh = pmesh.get_mesh_2d(2, axes=("data", "model"))
    wide = pmesh.leaf_sharding(mesh, torch.zeros(64, 3, 3, 3), "model")
    narrow = pmesh.leaf_sharding(mesh, torch.zeros(1, 3, 3, 3), "model")
    cell = pmesh.leaf_sharding(mesh, torch.zeros(3, 3, 8, 64), "model", dim=3)
    coords = [None] * world
    dist.all_gather_object(coords, (mesh.get_local_rank("data"),
                                    mesh.get_local_rank("model")))
    # replicate: every rank's module made rank 0's
    module = torch.nn.Linear(3, 2)
    with torch.no_grad():
        module.weight.fill_(float(rank))
    pmesh.replicate(mesh, module)
    # make_global_batch undoes shard_batch over the data axis
    batch = {k: torch.tensor(v) for k, v in tiny_batch().items()}
    batch["batch_weight"] = torch.arange(8.0)
    local = pmesh.shard_batch(mesh, batch)
    whole = pmesh.make_global_batch(mesh, local)
    out["leaf_rule"] = {
        "conv_64": wide == (Replicate(), Shard(0)),
        "conv_1": narrow == (Replicate(), Replicate()),
        "cell_64": cell == (Replicate(), Shard(3)),
        "coords": coords,
        "replicated": float(module.weight.abs().max()),
        "local_batch": local["images"].shape[1],
        "global_equal": all(torch.equal(whole[k], batch[k]) for k in batch),
    }
    return out


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def trainer_config(log_dir: str, **kw) -> Config:
    """The synthetic-data trainer of the checkpoint cases: one epoch of
    one batch of 4 (global), Adam, a sharded checkpoint at its end."""
    return Config(**dict(
        TINY, experiment="synthetic", log_dir=log_dir, jobname="run",
        batch_size=4, test_batch_size=4, niter=1, epoch_size=1,
        video_length=3, n_eval=3, eval_interval=100, checkpoint_interval=100,
        async_checkpoint=False, **kw))


def trainer_state(trainer) -> dict:
    """The trainer's parameters, BatchNorm statistics and optimizer state
    as whole JAX flat trees, and its step."""
    return dict(trainer._trees(), step=trainer._step)


def checkpoint_case(ckpt_in, log_dir):
    """An FSDP2 trainer at this world restores `ckpt_in` (written at world
    1), then trains in `log_dir` and writes its sharded checkpoint."""
    from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer

    cfg = trainer_config(log_dir, param_sharding="data")
    t = PredictionTrainer(cfg, device="cpu")
    t.load_checkpoint(ckpt_in)
    restored = trainer_state(t)
    t.train()
    out = {"restored": restored, "trained": trainer_state(t),
           "sharded_params": type(t.model.encoder.c1[0].conv.weight).__name__}
    t.logger.close()
    return out


def mesh_plans():
    """A mesh plan (candidates over the data axis) of two requests in
    float32 and int8, on seeded weights."""
    from robot_aware_control_tpu_torch.planning.cem import CEMPolicy

    mesh = pmesh.get_mesh(axis="data")
    out = {}
    for quant in ("none", "int8"):
        cfg = Config(**dict(PLAN, plan_quantize=quant))
        model = tsvg.init(cfg, seed=3, device="cpu")
        policy = CEMPolicy(cfg, model, device="cpu", mesh=mesh)
        out[quant] = plan_requests(policy)
    return out


def plan_requests(policy):
    """The plans of two seeded requests, one by one and batched."""
    from torch_serve_cases import requests

    reqs = requests(2, h=24, w=32)
    singles = [policy.get_action(s, g, ep_num=e, step=t)
               for s, g, e, t in reqs]
    batched = policy.get_action_batched(
        [r[0] for r in reqs], [r[1] for r in reqs],
        ep_nums=[r[2] for r in reqs], steps=[r[3] for r in reqs])
    return {"singles": singles, "batched": batched}
