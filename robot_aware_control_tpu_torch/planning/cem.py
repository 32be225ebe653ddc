"""CEM action optimization on one GPU.

Counterpart of `robot_aware_control_tpu/planning/cem.py` (reference:
src/cem/cem.py:56-111, pick variant src/cem/pick/cem.py:50-112, push
variant src/cem/push/cem.py:50-104). Each of `opt_iter` iterations samples
N action sequences, rolls them out through the model on the device, keeps
the top-K by reward and refits. Preserved semantics:

  * mean/std over (horizon-1, A); init std = cem_init_std (cem.py:74-75),
    the mean seeded from a demo's actions under --demo_cost,
  * a "do nothing" candidate injected at iteration 0 (cem.py:82-83;
    locobot variant only),
  * per-variant clamps: locobot +-0.05 (cem.py:85); push +-1; pick +-1
    with the gripper in [-0.01, 0], mean[-1] = -0.005, std[0] = 0.2,
    std[-1] = 0.005 (pick/cem.py:66-89); then zero-padded to the model's
    action_dim (cem.py:86),
  * candidates evaluated in chunks of candidates_batch_size
    (trajectory_sampler.py:72,123-127),
  * refit: mean/std of the top-K rewards (ties to the lower index, as
    jax.lax.top_k), unbiased std floored at 1e-3 (cem.py:96-104),
  * returns the final mean plan (cem.py:111).

Random draws come from a `torch.Generator` on the device per request,
seeded with cfg.seed + 7919 * ep_num + step as the JAX package seeds its
key: per iteration the action noise, then per chunk of candidates the
prior's noise of each model step (none for the deterministic families,
which have no prior).

With cfg.debug_cem, `get_action` rolls the final plan out once more with
its frames (`TrajectorySampler.generate_model_rollouts(ret_obs=True)`) and
writes them beside the last goal frame as
`<log_dir>/debug_cem_ep<ep>_step<step>.gif` (`training/plot.save_gif`,
which writes nothing without imageio), as the JAX policy's
`_plot_rollouts` does.

With --plan_quantize int8 the policy plans with an int8 copy of the model
(ops/quant.py:quantize_model, once, at construction, as the JAX policy
transforms its params): every convolution and conv cell of the rollout
multiplies int8 values into int32 sums, with one activation scale per
request's (and chunk's) rows; the caller's model stays float.

With a `mesh` (a torch.distributed DeviceMesh with a "data" axis) the
candidates shard over the data axis, the JAX package's
`with_sharding_constraint(acts, P("data"))` (cem.py:65-67, 124-128): N is
padded up to a multiple of the axis size, every rank draws the global
action and prior noise from its identically seeded generator and rolls out
its own N / n candidates (no chunking, as in the JAX package), the costs
are all-gathered, and every rank runs the same top-k and refit and returns
the same plan. Under int8 each conv's activation scale is the MAX over the
ranks (ops/quant.py:amax_group). A mesh planner plans batched requests one
after another (cem.py:245-248).

`get_action_batched` plans R requests together: per iteration one rollout
of R x N candidates (R x chunk with chunking) through the same kernels,
top-k and refit per request. Each request draws from its own generator in
the order `get_action` draws; the model steps run once over all rows on
kernels whose result for a row depends on that row alone (ops/kernels.py),
but for the convolutions, which take each request's rows apart, and every
operation whose bits could depend on the batch (costs, top-k, refit) runs
per request (planning/rollout.py). So a request's batched plan is its
single plan, bit for bit (tests/test_torch_port_serving.py; on the card,
chip_smoke.py).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.registry import is_stochastic
from robot_aware_control_tpu_torch.ops import quant
from robot_aware_control_tpu_torch.parallel.mesh import (
    all_gather_rows,
    mesh_axis,
    split_rows,
)
from robot_aware_control_tpu_torch.planning.rollout import (
    RolloutEngine,
    TrajectorySampler,
    request_inputs,
)
from robot_aware_control_tpu_torch.training import plot
from robot_aware_control_tpu_torch.training.step import prior_shape
from robot_aware_control_tpu_torch.utils.device import resolve_device
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State


class CEMPolicy:
    """Locobot/real-robot planar CEM (reference: src/cem/cem.py:14-111)."""

    action_dim = 2
    zero_candidate = True
    engine_pick = False

    def __init__(self, cfg: Config, model, device="cuda", horizon=None,
                 opt_iter=None, action_candidates=None, topk=None,
                 init_std=None, mesh=None, **engine_kw):
        self.cfg = cfg
        self.device = resolve_device(device)
        # --plan_quantize int8: the rollout's convolutions in int8
        # (ops/quant.py; planning is forward-only)
        self.model = quant.maybe_quantize_plan_model(cfg, model)
        # sampled actions are zero-padded to the model's action space
        # (reference: cem.py:86 pads 2-D planar actions to 5-D robonet actions)
        self.pad_to = cfg.action_dim
        self.horizon = horizon or cfg.horizon
        self.opt_iter = opt_iter or cfg.opt_iter
        self.num_candidates = action_candidates or cfg.action_candidates
        self.topk = topk or cfg.topk
        self.init_std = init_std if init_std is not None else cfg.cem_init_std
        # the candidates shard over the mesh's data axis
        self.mesh = mesh
        self._group, self._index, self._ranks = (
            (None, 0, 1) if mesh is None else mesh_axis(mesh, "data"))
        self.num_candidates = -(-self.num_candidates // self._ranks) * self._ranks
        engine_kw.setdefault("pick", self.engine_pick)
        self.engine = RolloutEngine(cfg, device=self.device, **engine_kw)

    # --- variant hooks -------------------------------------------------
    def init_mean_std(self, T: int, opt_traj=None):
        """(reference: cem.py:74-75). With --demo_cost and a demo action
        prefix, the mean is seeded from the demo (pick/cem.py:68-69)."""
        mean = torch.zeros(T - 1, self.action_dim, device=self.device)
        std = torch.full((T - 1, self.action_dim), float(self.init_std),
                         device=self.device)
        if opt_traj is not None and self.cfg.demo_cost:
            opt = _demo_prefix(opt_traj, T, self.action_dim, self.device)
            mean[: len(opt)] = opt
        return mean, std

    def clamp(self, acts):
        """(reference: cem.py:85)"""
        return torch.clamp(acts, -0.05, 0.05)

    def pad(self, acts):
        """Zero-pad sampled actions (..., A) to the model's action space
        (reference: cem.py:86)."""
        A = acts.shape[-1]
        if A >= self.pad_to:
            return acts
        return torch.cat([acts, acts.new_zeros(acts.shape[:-1]
                                               + (self.pad_to - A,))], -1)

    # --- the optimizer ---------------------------------------------------
    def _host_prep(self, start: State, goal: DemoGoalState, ep_num=0,
                   step=0, opt_traj=None, rng=None):
        """Normalization, frame shift, goal padding and seeding of one
        request: (inputs on the device (start_img, start_state_norm,
        start_qpos, goal_imgs, goal_masks, goal_states; None where absent),
        generator, mean0, std0)."""
        T = self.horizon
        inputs = request_inputs(self.cfg, start, goal, T - 1,
                                self.engine.qpos_dim)
        inputs = tuple(None if a is None else
                       torch.tensor(a, device=self.device) for a in inputs)
        if rng is None:
            rng = self._generator(ep_num, step)
        mean0, std0 = self.init_mean_std(T, opt_traj)
        return inputs, rng, mean0, std0

    def _generator(self, ep_num, step) -> torch.Generator:
        """The request's generator on the device, seeded with cfg.seed +
        7919 * ep_num + step as the JAX package seeds its key."""
        rng = torch.Generator(device=self.device)
        rng.manual_seed(self.cfg.seed + 7919 * ep_num + step)
        return rng

    def _noise(self, noise):
        """Injected action noise (opt_iter, N, horizon-1, action_dim) as a
        tensor on the device, or None."""
        if noise is None:
            return None
        noise = torch.tensor(np.asarray(noise), dtype=torch.float32,
                             device=self.device)
        want = (self.opt_iter, self.num_candidates, self.horizon - 1,
                self.action_dim)
        if tuple(noise.shape) != want:
            raise ValueError(f"noise must be {want}, got {tuple(noise.shape)}")
        return noise

    @torch.inference_mode()
    def _plan(self, preps, noise=None):
        """Plans the requests of `preps` (_host_prep's results, which agree
        on which goal inputs they carry) together. `noise` (opt_iter, N,
        horizon-1, action_dim) replaces every request's action noise.
        Returns the mean plans (R, horizon-1, action_dim)."""
        cfg, dev = self.cfg, self.device
        R, T = len(preps), self.horizon
        N, K = self.num_candidates, self.topk
        n_local = N // self._ranks
        # under a mesh each rank rolls out its n_local candidates at once
        chunk = n_local if self.mesh is not None else min(
            int(cfg.candidates_batch_size or N), N)
        while N % chunk:
            chunk -= 1
        inputs = [None if preps[0][0][i] is None else
                  torch.stack([p[0][i] for p in preps]) for i in range(6)]
        gens = [p[1] for p in preps]
        mean = torch.stack([p[2] for p in preps])
        std = torch.stack([p[3] for p in preps])
        # the prior's draws are the global batch's (N rows under a mesh)
        prior = prior_shape(cfg, chunk * self._ranks)
        stochastic = is_stochastic(cfg)
        for i in range(self.opt_iter):
            eps = torch.stack([noise[i] if noise is not None else torch.randn(
                (N,) + tuple(mean.shape[1:]), generator=g, device=dev)
                for g in gens])
            acts = mean[:, None] + std[:, None] * eps
            if self.zero_candidate and i == 0:
                acts[:, -1] = 0.0  # "do nothing" candidate (cem.py:82-83)
            acts = self.clamp(acts)
            padded = split_rows(self.pad(acts), self._index, self._ranks, 1)
            sum_cost = []
            for s in range(0, n_local, chunk):
                # each request's prior noise, one draw a model step, as the
                # model would draw it (det draws nothing); a mesh rank
                # keeps its candidates' rows of the global draw
                eps_prior = torch.cat([split_rows(torch.stack([
                    torch.randn(prior, generator=g, device=dev)
                    for _ in range(T - 1)]), self._index, self._ranks, 1)
                    for g in gens], 1) if stochastic else None
                cands = padded[:, s:s + chunk].reshape(
                    (R * chunk,) + padded.shape[2:])
                with quant.amax_group(self._group):
                    sum_cost.append(self.engine(
                        self.model, inputs[0], inputs[1], inputs[2], cands,
                        inputs[3], inputs[4], goal_states=inputs[5],
                        eps_prior=eps_prior).view(R, chunk))
            sum_cost = all_gather_rows(torch.cat(sum_cost, 1), self._group,
                                       self._ranks, 1)
            # top-k and refit per request (a reduction over a batch of
            # requests may add in another order); equal costs rank the lower
            # index first, as jax.lax.top_k does (pick rollouts clipped to
            # the workspace tie)
            refit = []
            for r in range(R):
                top = torch.sort(sum_cost[r], descending=True, stable=True)
                top_act = acts[r][top.indices[:K]]
                refit.append((top_act.mean(0), torch.clamp(
                    top_act.std(0, unbiased=True), min=1e-3)))
            mean = torch.stack([m for m, _ in refit])
            std = torch.stack([s for _, s in refit])
        return mean

    # --- host API -------------------------------------------------------
    def get_action(self, start: State, goal: DemoGoalState, ep_num=0, step=0,
                   opt_traj=None, rng=None, noise=None):
        """Returns the mean plan (horizon-1, action_dim) as numpy
        (reference: cem.py:56-111). `rng`, a torch.Generator on the
        policy's device, replaces the seeded one; `noise`, shaped
        (opt_iter, N, horizon-1, action_dim), replaces the sampled action
        noise (for tests)."""
        prep = self._host_prep(start, goal, ep_num, step, opt_traj, rng)
        mean = self._plan([prep], self._noise(noise))[0].cpu().numpy()
        if self.cfg.debug_cem:
            self._plot_rollouts(mean, start, goal, ep_num, step)
        return mean

    def get_action_batched(self, starts, goals, ep_nums=None, steps=None,
                           opt_trajs=None):
        """Plans R independent requests together, the serving idiom for
        several robots sharing one planner (control/plan_server.py).
        Returns (R, horizon-1, action_dim); result[i] equals
        get_action(starts[i], goals[i], ep_nums[i], steps[i], opt_trajs[i])
        bit for bit. R is padded to the next power of two by repeating the
        last request, as the JAX package buckets it (cem.py:269-271)."""
        R = len(starts)
        ep_nums = ep_nums if ep_nums is not None else [0] * R
        steps = steps if steps is not None else [0] * R
        opt_trajs = opt_trajs if opt_trajs is not None else [None] * R
        reqs = list(zip(starts, goals, ep_nums, steps, opt_trajs))
        has = lambda g: (g.masks is not None, g.states is not None)
        if len({has(g) for g in goals}) > 1:
            raise ValueError("batched requests must agree on goal masks/"
                             "states presence")
        if self.mesh is not None:  # requests one after another
            return np.stack([self._plan([self._host_prep(*r)])[0].cpu().numpy()
                             for r in reqs])
        # the padding repeats the last request with a generator of its own
        reqs += [reqs[-1]] * ((1 << (R - 1).bit_length()) - R)
        preps = [self._host_prep(*r) for r in reqs]
        return self._plan(preps)[:R].cpu().numpy()

    def _plot_rollouts(self, plan, start: State, goal: DemoGoalState,
                       ep_num, step):
        """The final plan's rollout beside the last goal frame as a gif
        (JAX `cem.py:_plot_rollouts`; reference: cem.py:113-179). The
        rollout draws the prior's noise from a generator seeded with
        cfg.seed, as the JAX sampler's default key. Returns the frames
        handed to `save_gif`, (horizon-1) x (H, 2 W, C)."""
        acts = self.pad(torch.tensor(plan)[None]).numpy()
        sampler = TrajectorySampler(self.cfg, self.model, engine=self.engine)
        out = sampler.generate_model_rollouts(acts, start, goal, ret_obs=True)
        goal_img = np.asarray(goal.imgs[-1], np.float32)
        if goal_img.max() > 1.5:
            goal_img = goal_img / 255.0
        frames = [np.concatenate([f, goal_img], axis=1) for f in out["obs"][0]]
        os.makedirs(self.cfg.log_dir, exist_ok=True)
        plot.save_gif(os.path.join(self.cfg.log_dir,
                                   f"debug_cem_ep{ep_num}_step{step}.gif"),
                      frames, fps=2)
        return frames


def _demo_prefix(opt_traj, T, action_dim, device):
    return torch.tensor(np.asarray(opt_traj, np.float32),
                           device=device)[: T - 1, :action_dim]


class PushCEMPolicy(CEMPolicy):
    """LocobotPushEnv planar variant (reference: src/cem/push/cem.py:50-104):
    clamp +-1, no do-nothing candidate."""

    zero_candidate = False

    def clamp(self, acts):
        return torch.clamp(acts, -1.0, 1.0)


class PickCEMPolicy(CEMPolicy):
    """LocobotPickEnv 4-D (xyz + gripper) variant
    (reference: src/cem/pick/cem.py:50-112)."""

    action_dim = 4
    zero_candidate = False
    engine_pick = True

    def init_mean_std(self, T: int, opt_traj=None):
        """(reference: pick/cem.py:66-74: std = init_std with x-std 0.2,
        gripper mean -0.005 / std 0.005). When the mean is demo-seeded
        (--demo_cost + demo actions) exploration stays local around the
        seed unless --pick_wide_x_std."""
        dev = self.device
        mean = torch.zeros(T - 1, 4, device=dev)
        mean[:, -1] = -0.005
        std = torch.full((T - 1, 4), float(self.init_std), device=dev)
        seeded = opt_traj is not None and self.cfg.demo_cost
        local = seeded and not self.cfg.pick_wide_x_std
        if not local:
            std[:, 0] = 0.2
        std[:, -1] = 0.005 if not local else self.init_std / 3
        if seeded:
            opt = _demo_prefix(opt_traj, T, 4, dev)
            mean[: len(opt)] = opt
        return mean, std

    def clamp(self, acts):
        acts = torch.clamp(acts, -1.0, 1.0)
        return torch.cat([acts[..., :-1],
                          torch.clamp(acts[..., -1:], -0.01, 0.0)], -1)
