"""Device meshes, parameter layouts and the batch split on torch.distributed.

Counterpart of `robot_aware_control_tpu/parallel/mesh.py`. The JAX package
runs one program over a mesh of chips and lets XLA's SPMD partitioner
insert the collectives; here each rank of a process group is one process
on one device (NCCL on GPUs, gloo on the CPU), and the collectives are
explicit:

  * a (data, model) `DeviceMesh`, the model axis innermost (`get_mesh`,
    `get_mesh_2d`), over the ranks of the default process group;
  * the leaf rule (`leaf_sharding`): shard a parameter's output-channel
    axis over a mesh axis when it divides evenly, replicate it otherwise.
    The output channels are dim 0 of an OIHW conv weight, of a Linear
    weight and of a bias or norm vector, and the last dim of a conv cell's
    (k, k, I, O) weight (`out_channel_dim`); the JAX layouts keep them
    last everywhere, so one trailing-axis rule shards the same channels;
  * the trainer's layouts (`Layout`): `replicated` (DDP over the data
    axis), `data` (FSDP2 `fully_shard` over the data axis) and `model`
    (parameters as DTensors sharded by the leaf rule over the model axis
    and gathered at use, gradients averaged over the data axis);
  * the batch split: batch sizes are global, each rank keeps its data
    index's slice (`shard_batch`; axis 1 of the time-first arrays, axis 0
    of the per-element keys) and reads its share of the files
    (`host_shard_files`).

Under the JAX package's single program three things hold by construction
that a sharded step here must arrange itself, or it silently stops
equalling the replicated step: BatchNorm's batch statistics are global
(ops/nn.py:batch_stats_group all-reduces them over the data axis), the
random draws are the rank's slice of the global draw (`Layout.local_noise`),
and losses whose normaliser depends on the batch reduce it globally (the
port's losses are plain means over equal shards, so the data axis's
average gradient is the global one; the logged metrics are averaged the
same way, `Layout.mean`).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def process_info() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _ranks(num_devices: int) -> int:
    world = process_info()[1]
    if num_devices and num_devices != world:
        raise ValueError(f"num_devices={num_devices}: a mesh spans every rank "
                         f"of the process group, which has {world}")
    return world


def get_mesh(num_devices: int = 0, axis: str = "data"):
    """1-D mesh over the ranks of the default process group (num_devices
    0, or the world size)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _ranks(num_devices)
    return init_device_mesh(_device_type(), (n,), mesh_dim_names=(axis,))


def get_mesh_2d(model_axis_size: int, num_devices: int = 0,
                axes=("data", "model")):
    """2-D (data, model) mesh: batches split over "data", channel-sharded
    parameters over "model", the model axis innermost (ranks r and r + 1
    share a data index)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = _ranks(num_devices)
    if n % model_axis_size:
        raise ValueError(
            f"{n} devices not divisible by model_axis_size={model_axis_size}")
    return init_device_mesh(_device_type(), (n // model_axis_size,
                                             model_axis_size),
                            mesh_dim_names=tuple(axes))


def out_channel_dim(module: nn.Module, name: str) -> int:
    """The output-channel dim of `module`'s parameter `name`: the last of a
    conv cell's (k, k, I, O) gate weight, dim 0 of everything else."""
    from robot_aware_control_tpu_torch.ops.lstm import ConvLSTMCell

    return 3 if isinstance(module, ConvLSTMCell) and name == "weight" else 0


def leaf_sharding(mesh, x, axis: str, dim: int = 0) -> tuple:
    """The placements of one leaf on `mesh` (JAX `leaf_sharding`): Shard(dim)
    on `axis` when x.shape[dim] divides evenly by the axis's size (and is
    at least as large), Replicate everywhere else."""
    from torch.distributed.tensor import Replicate, Shard

    shape = tuple(getattr(x, "shape", ()))
    names = mesh.mesh_dim_names
    size = mesh.size(names.index(axis))
    shard = (len(shape) >= 1 and shape[dim] % size == 0
             and shape[dim] >= size)
    return tuple(Shard(dim) if shard and n == axis else Replicate()
                 for n in names)


def shard_params(mesh, module: nn.Module, axis: str = "model") -> nn.Module:
    """Every parameter of `module` as a DTensor on `mesh` with the leaf
    rule's placements over `axis` (in place; returns the module). A
    one-axis sub-mesh (`mesh[axis]`) keeps the other axes' ranks apart."""
    from torch.distributed.tensor import distribute_tensor

    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is None:
                continue
            place = leaf_sharding(mesh, p, axis, out_channel_dim(mod, name))
            setattr(mod, name, nn.Parameter(
                distribute_tensor(p.data, mesh, place),
                requires_grad=p.requires_grad))
    return module


@torch.no_grad()
def replicate(mesh, module: nn.Module, axis: Optional[str] = None) -> nn.Module:
    """`module`'s parameters and buffers made equal on every rank of `mesh`
    (along `axis` alone if given): broadcast from each axis group's first
    rank, axis by axis, so that every rank ends with the first rank's.
    Returns the module."""
    for ax in [axis] if axis else mesh.mesh_dim_names:
        group = mesh.get_group(ax)
        src = dist.get_global_rank(group, 0)
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
    return module


def host_shard_files(items, process_index: int = None,
                     process_count: int = None):
    """This rank's disjoint slice of a work list (files, episodes): items
    index, index + count, ... The slices of all ranks cover the list."""
    if process_index is None or process_count is None:
        process_index, process_count = process_info()
    if process_count <= 1:
        return list(items)
    return list(items)[process_index::process_count]


def data_info(cfg) -> tuple:
    """(data index, data axis size) of this rank: the ranks of one model
    group (cfg.model_axis_size consecutive ranks) read the same data."""
    rank, world = process_info()
    m = max(1, cfg.model_axis_size)
    return rank // m, max(world // m, 1)


# Batch-dict keys whose arrays are per-element (B, ...) rather than
# time-first (T, B, ...): their batch dim is axis 0, not the default.
PER_ELEMENT_KEYS = (
    "batch_weight", "low", "high", "raw_low", "raw_high", "high_movement",
)


def batch_axis_for(key, default: int = 1) -> int:
    return 0 if key in PER_ELEMENT_KEYS else default


def _axis_coords(mesh, axis: str) -> tuple:
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


def shard_batch(mesh, batch: dict, batch_axis_index: int = 1,
                axis: str = "data") -> dict:
    """This rank's slice of a global batch dict: time-first arrays (T, B,
    ...) along B, the per-element keys (PER_ELEMENT_KEYS) along axis 0, by
    the rank's index on `axis`. Arrays without a batch axis, and anything
    that is not an array, pass through. B must divide by the axis size."""
    index, count = _axis_coords(mesh, axis)

    def take(k, x):
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            return x
        ax = batch_axis_for(k, batch_axis_index)
        if x.ndim <= ax:
            return x
        if x.shape[ax] % count:
            raise ValueError(f"{k}: batch {x.shape[ax]} does not divide "
                             f"over {count} ranks")
        n = x.shape[ax] // count
        idx = [slice(None)] * x.ndim
        idx[ax] = slice(index * n, (index + 1) * n)
        return x[tuple(idx)]

    return {k: take(k, v) for k, v in batch.items()}


def make_global_batch(mesh, local_batch: dict, batch_axis_index: int = 1,
                      axis: str = "data") -> dict:
    """The global batch on every rank from each rank's local tensors: an
    all-gather over `axis` concatenated along each key's batch axis (the
    inverse of `shard_batch`). Tensors without a batch axis pass through."""
    index, count = _axis_coords(mesh, axis)
    if count == 1:
        return dict(local_batch)
    group = mesh.get_group(axis)

    def gather(k, x):
        ax = batch_axis_for(k, batch_axis_index)
        if not isinstance(x, torch.Tensor) or x.ndim <= ax:
            return x
        parts = [torch.empty_like(x) for _ in range(count)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, ax)

    return {k: gather(k, v) for k, v in local_batch.items()}


def pad_to_multiple(x: np.ndarray, axis: int, multiple: int):
    """Pad axis up to a multiple by repeating the edge (uneven final
    batches). Returns (padded, original_size)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x, size
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - size)
    return np.pad(x, pad, mode="edge"), size


# ---------------------------------------------------------------------------
# the trainer's layouts


@contextlib.contextmanager
def gathered(module: nn.Module):
    """Inside, every DTensor parameter of `module` reads as its full tensor
    (an all-gather over its mesh, differentiable: the gradient reaches the
    local shard). Outside, the DTensors are back."""
    from torch.distributed.tensor import DTensor

    swapped = []
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if isinstance(p, DTensor):
                swapped.append((mod, name, p))
                mod._parameters[name] = p.full_tensor()
    try:
        yield module
    finally:
        for mod, name, p in swapped:
            mod._parameters[name] = p


class Layout:
    """The trainer's parallel layout over the default process group
    (JAX `trainer.py:92-123`): a (data, model) mesh of the world, the model
    axis cfg.model_axis_size ranks wide, named by cfg.mesh_axes (the data
    axis first, then the model axis, "model" by default), and
    cfg.param_sharding's placement of the parameters and optimizer state:

      * replicated: every rank holds all of them; DDP averages the
        gradients over the data axis;
      * data: FSDP2 (`fully_shard` over the data axis), each parameter
        sharded by the leaf rule (FSDP2 pads where a dim does not divide),
        gathered at use, gradients reduce-scattered;
      * model: DTensors sharded by the leaf rule over the model axis,
        gathered at use (`gathered`), their gradients' shards averaged over
        the data axis. At a model axis of 1 nothing is sharded, which the
        JAX package runs replicated: the same numbers.

    Batch sizes are global and must divide by the data axis (the JAX
    trainer drops devices until they do; a process group's ranks cannot be
    dropped, so the port raises)."""

    def __init__(self, cfg):
        if not dist.is_initialized():
            raise RuntimeError("a layout needs an initialised process group")
        rank, world = process_info()
        tp = max(1, cfg.model_axis_size)
        axes = tuple(cfg.mesh_axes) or ("data",)
        self.data_axis = axes[0]
        self.model_axis = axes[1] if len(axes) > 1 else "model"
        self.mesh = get_mesh_2d(tp, cfg.num_devices,
                                axes=(self.data_axis, self.model_axis))
        self.kind = cfg.param_sharding
        self.data_index, self.data_size = _axis_coords(self.mesh,
                                                       self.data_axis)
        for name in ("batch_size", "test_batch_size"):
            bs = getattr(cfg, name)
            if bs % self.data_size:
                raise ValueError(
                    f"{name}={bs} does not divide over the data axis of "
                    f"{self.data_size} ranks (world {world}, model axis {tp})")
        self.data_group = self.mesh.get_group(self.data_axis)
        self.rank = rank

    # --- parameters ------------------------------------------------------
    def wrap(self, window: nn.Module, model: nn.Module) -> nn.Module:
        """`window`, the train step's module (its forward runs a whole
        window of `model`), in this layout: DDP, FSDP2 or gathered DTensors.
        Build the optimizer on the returned module's parameters."""
        if self.kind == "replicated":
            from torch.nn.parallel import DistributedDataParallel as DDP

            dev = next(window.parameters()).device
            return DDP(window, process_group=self.data_group,
                       device_ids=[dev.index] if dev.type == "cuda" else None,
                       broadcast_buffers=False, find_unused_parameters=True)
        if self.kind == "data":
            from torch.distributed.fsdp import fully_shard
            from torch.distributed.tensor import Shard

            dims = {p: out_channel_dim(mod, name)
                    for mod in model.modules()
                    for name, p in mod._parameters.items() if p is not None}
            size = self.data_size

            def place(p):
                d = dims.get(p, 0)
                return Shard(d) if p.shape[d] % size == 0 else None

            return fully_shard(window, mesh=self.mesh[self.data_axis],
                               shard_placement_fn=place)
        shard_params(self.mesh[self.model_axis], model, self.model_axis)
        return window

    def train_params(self, model: nn.Module):
        """The context a train step's forward and backward run in: the
        `model` layout's gathered parameters (the backward recomputes
        checkpointed steps on them), nothing for DDP and FSDP2, which
        gather their own."""
        if self.kind == "model":
            return gathered(model)
        return contextlib.nullcontext()

    @torch.no_grad()
    def sync_grads(self, params):
        """The `model` layout's gradient average over the data axis (DDP
        and FSDP2 reduce theirs in the backward pass)."""
        if self.kind != "model" or self.data_size == 1:
            return
        for p in params:
            if p.grad is not None:
                g = p.grad.to_local()
                dist.all_reduce(g, group=self.data_group)
                g.div_(self.data_size)

    @contextlib.contextmanager
    def full_params(self, window: nn.Module, model: nn.Module):
        """Inside, `model` holds its whole parameters (eval steps,
        checkpoint conversion): FSDP2's unshard, or the gathered DTensors."""
        if self.kind == "data":
            window.unshard()
            try:
                yield model
            finally:
                window.reshard()
        elif self.kind == "model":
            with torch.no_grad(), gathered(model):
                yield model
        else:
            yield model

    # --- batches and draws -----------------------------------------------
    def local(self, t: Optional[torch.Tensor], axis: int):
        """This rank's slice of a global tensor along `axis`."""
        if t is None or self.data_size == 1:
            return t
        n = t.shape[axis] // self.data_size
        return t.narrow(axis, self.data_index * n, n)

    def local_noise(self, noise: dict) -> dict:
        """A window's draws (training/step.py:draw_noise, drawn for the
        global batch from a generator seeded alike on every rank) cut to
        this rank's rows: the priors' (steps, B, ...) along B, the dropout
        masks (steps, frames, B, C) along B; the scheduled-sampling draw
        has no batch axis."""
        out = dict(noise, eps_prior=self.local(noise["eps_prior"], 1),
                   eps_post=self.local(noise["eps_post"], 1))
        if noise.get("drop") is not None:
            out["drop"] = [self.local(m, 2) for m in noise["drop"]]
        return out

    def mean(self, values: dict) -> dict:
        """Each 0-d or per-step tensor averaged over the data axis (the
        metrics of equal shards' plain means are the global batch's)."""
        if self.data_size == 1:
            return values
        keys = sorted(values)
        flat = torch.stack([values[k].float().reshape(-1) for k in keys])
        dist.all_reduce(flat, group=self.data_group)
        flat = flat / self.data_size
        return {k: flat[i].reshape(values[k].shape).to(values[k].dtype)
                for i, k in enumerate(keys)}


def split_rows(x: torch.Tensor, index: int, count: int, axis: int = 0):
    """Rows index * n : (index + 1) * n of `x` along `axis`, n = size /
    count (a mesh planner's share of its candidates)."""
    n = x.shape[axis] // count
    return x.narrow(axis, index * n, n)


def all_gather_rows(x: torch.Tensor, group, count: int, axis: int = 0):
    """Every rank's `x` concatenated along `axis` in rank order."""
    if count == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(count)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, axis)


def mesh_axis(mesh, axis: str = "data") -> tuple:
    """(group, index, size) of this rank on `axis` of `mesh`."""
    index, size = _axis_coords(mesh, axis)
    return mesh.get_group(axis), index, size

