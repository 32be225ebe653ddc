"""Shared cases of the simulation slice (envs/, planning/gt_rollout.py,
control/episode_runner.py), JAX-free: the CPU parity tests hold the port
to the JAX package on them, and the GPU tests and chip_smoke.py's `sim`
phase hold the card to the CPU on them. Not a test module.

Scripted start states and 20+ step action sequences that exercise every
branch of the physics: tip-block contact (LocobotPush), block chains of
three (ClutterPush), and grab, carry, release and drop (LocobotPick). The
poses stay away from the contact thresholds (`overlap > 1e-6`,
`|shove| > 1e-6`, the grab radii), so float32 rounding cannot flip a
branch between two devices or two packages."""

from __future__ import annotations

import time

import numpy as np
import torch

from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control.episode_runner import PushEpisodeRunner
from robot_aware_control_tpu_torch.data.demo_io import demo_from_history
from robot_aware_control_tpu_torch.envs.base import SimState, physics_step, solve_qpos
from robot_aware_control_tpu_torch.envs.variants import make
from robot_aware_control_tpu_torch.models import svg, torch_export, torch_import
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.planning.gt_rollout import GTPushCEMPolicy
from robot_aware_control_tpu_torch.utils.state import DemoGoalState
from torch_variant_cases import CANONICAL, start_goal

SIM_ENVS = ("LocobotPush", "LocobotPick", "ClutterPush")
STEPS = 20
# card vs CPU: positions (m) and images; masks must be equal
POS_TOL = 1e-5
IMG_TOL = 1e-5
GT_PLAN_TOL = 1e-5
# the small GT plan of the parity checks
GT_SMALL = dict(horizon=4, opt_iter=3, action_candidates=12, topk=3,
                reward_type="dontcare", image_height=48, image_width=64,
                seed=0)
# the canonical planning config of bench.py:266-287 in the push env
GT_CANONICAL = dict(horizon=5, opt_iter=10, action_candidates=100, topk=5,
                    reward_type="dontcare", image_height=48, image_width=64,
                    seed=0)
# a PushEpisodeRunner episode of 4 steps, replanning every step
EPISODE = dict(env="LocobotPush", replan_every=1, max_episode_length=5,
               num_episodes=1, record_video_interval=0, jobname="sim")
GT_EPISODE = dict(GT_CANONICAL, use_env_dynamics=True, **EPISODE)
# the canonical learned planner; the env's actions are 0.05 m a unit
LEARNED_EPISODE = dict(CANONICAL, eef_action_scale=0.05, **EPISODE)


def _flat(eef, objs, K):
    """A flattened SimState at rest: the joints solved for eef on the CPU."""
    eef = np.asarray(eef, np.float32)
    qpos = solve_qpos(torch.tensor(eef), torch.zeros(5)).numpy()
    objs = np.asarray(objs, np.float32).reshape(K, 3)
    return np.concatenate([eef, qpos, objs.ravel(), [1.0], np.zeros(K),
                           np.zeros(2 * K)]).astype(np.float32)


def sim_case(env_name: str, steps: int = STEPS, seed: int = 0):
    """(flattened start state, actions (steps, action_dim)) of an env:
    a push into one block, a push into a row of three (a chain), or a
    pick: descend with the gripper closing (grab), lift and carry, open
    (release and drop), then push the dropped block."""
    env = make(env_name, Config(), device="cpu")
    A, K = env.action_dim, env.num_objects
    rng = np.random.RandomState(seed)
    acts = np.zeros((steps, A), np.float32)
    if env.pick:
        start = _flat([0.335, 0.05, 0.21], [0.33, 0.05, 0.12], K)
        script = ([(0, 0, -1, -0.01)] * 2 + [(0, 0, 1, -0.01)] * 3
                  + [(0.6, 0.3, 0, -0.01)] * 4 + [(0, 0, 0, 0)]
                  + [(0, 0, -1, 0)] * 2)
        acts[:len(script)] = script
        tail = steps - len(script)
        acts[len(script):, 0] = -0.8 + 0.1 * rng.randn(tail)
        acts[len(script):, 1] = -0.6 + 0.1 * rng.randn(tail)
        return start, np.clip(acts, -1.0, 1.0)
    if K == 1:
        start = _flat([0.26, 0.012, 0.15], [0.33, 0.0, 0.12], K)
    else:  # a row of blocks 0.046 m apart: a push moves all three
        start = _flat([0.26, 0.004, 0.15],
                      [[0.33, 0.0, 0.12], [0.376, 0.003, 0.12],
                       [0.422, -0.002, 0.12]], K)
    base = np.where(np.arange(steps)[:, None] < steps // 2,
                    [[0.9, 0.05]], [[0.2, -0.8]])
    acts[:, :2] = base + 0.15 * rng.randn(steps, 2)
    return start, np.clip(acts, -1.0, 1.0)


def run_case(env, start, actions):
    """Replays actions from a flattened start state. Returns per-step numpy
    arrays: flat states (steps + 1, S), images and masks (steps, h, w, .)."""
    env.reset()
    env.set_flattened_state(start)
    flats, imgs, masks = [env.get_flattened_state()], [], []
    for a in actions:
        obs, _, _, _ = env.step(a)
        flats.append(env.get_flattened_state())
        imgs.append(obs["observation"])
        masks.append(obs["masks"])
    return dict(flat=np.stack(flats), img=np.stack(imgs),
                mask=np.stack(masks))


def case_coverage(env, run) -> dict:
    """What a run exercised: blocks moved by contact, blocks moved of a
    chain (all but the first), grabs and drops."""
    K = env.num_objects
    obj = run["flat"][:, 8:8 + 3 * K].reshape(-1, K, 3)
    att = run["flat"][:, 9 + 3 * K:9 + 4 * K]
    moved = np.abs(obj[-1, :, :2] - obj[0, :, :2]).max(-1) > 1e-3
    return dict(moved=int(moved.sum()),
                grabs=int(((att[1:] > 0.5) & (att[:-1] < 0.5)).sum()),
                drops=int(((att[1:] < 0.5) & (att[:-1] > 0.5)).sum()))


def physics_card_vs_cpu(env_name: str, dev) -> dict:
    """The same start and actions on the card and on the CPU: the worst
    position and image differences and the mask pixels that differ over
    STEPS steps, and what the run exercised."""
    start, actions = sim_case(env_name)
    runs = {}
    for d in ("cpu", dev):
        runs[str(d)] = run_case(make(env_name, Config(), device=d), start,
                                actions)
    a, b = runs["cpu"], runs[str(dev)]
    env = make(env_name, Config(), device="cpu")
    return dict(pos_err=float(np.abs(a["flat"] - b["flat"]).max()),
                img_err=float(np.abs(a["img"] - b["img"]).max()),
                mask_differ=int((a["mask"] != b["mask"]).sum()),
                coverage=case_coverage(env, a))


def gt_scenes(dev, n: int = 100, horizon: int = 5, seed: int = 0):
    """One GT CEM iteration's scenes in LocobotPush: the joints of n
    candidates x (horizon - 1) steps from a reset state, as the renderer
    gets them, and the renderer. Returns (renderer, qpos (n * T, 5))."""
    env = make("LocobotPush", Config(), seed=seed, device=dev)
    env.reset()
    rng = np.random.RandomState(seed)
    acts = torch.tensor(rng.randn(n, horizon - 1, 2).astype(np.float32),
                        device=dev).clamp(-1.0, 1.0)
    state = SimState(*(x.expand((n,) + x.shape) for x in env.state))
    qs = []
    for t in range(horizon - 1):
        state = physics_step(state, acts[:, t])
        qs.append(state.qpos)
    return env.renderer, torch.stack(qs, 1).reshape(-1, 5)


def gt_mask_kernel_vs_plain(dev, n: int = 100, horizon: int = 5) -> dict:
    """The mask kernel at one GT iteration's launch (M = n x (horizon - 1)
    thin capsules) and at one observation's (M = 1) against its plain
    version on the same segments: differing pixels (must be 0)."""
    renderer, qpos = gt_scenes(dev, n, horizon)
    out = {}
    for name, q in (("gt", qpos), ("obs", qpos[:1])):
        segs = renderer.segment_params(q).float().contiguous()
        got = kernels.capsule_mask_render(segs, renderer.h, renderer.w)
        want = kernels.capsule_mask_render_plain(segs, renderer.h, renderer.w)
        out[name] = dict(M=int(segs.shape[0]), S=int(segs.shape[1]),
                         differ=int((got != want).sum()),
                         inside=float(want.mean()))
    return out


def push_demo(env, length: int = 8) -> dict:
    """A scripted push (the env's straight_push demo of `length` frames)
    as the runner's demo dict, made in memory by `demo_from_history` (the
    runner's input on a machine without h5py); the env is reset after."""
    cfg = env._config
    env._config = (cfg or Config()).replace(demo_length=length)
    demo = demo_from_history(env, env.generate_demo())
    env._config = cfg
    env.reset()
    return demo


def push_goal(env, length: int = 8) -> DemoGoalState:
    """`push_demo`'s frames after the first as a goal."""
    demo = push_demo(env, length)
    return DemoGoalState(imgs=list(demo["observations"][1:]),
                         masks=list(demo["masks"][1:]),
                         states=list(demo["robot_state"][1:]))


def small_gt_plan_parity(dev) -> float:
    """A small GT plan in LocobotPush with injected noise on the card
    against the CPU's: the worst plan difference."""
    cfg = Config(**GT_SMALL)
    noise = np.random.RandomState(2).randn(
        cfg.opt_iter, cfg.action_candidates, cfg.horizon - 1, 2)
    plans = {}
    for d in ("cpu", dev):
        env = make("LocobotPush", cfg, seed=1, device=d)
        goal = push_goal(env)
        plans[str(d)] = GTPushCEMPolicy(cfg, env).get_action(None, goal,
                                                            noise=noise)
    return float(np.abs(plans["cpu"] - plans[str(dev)]).max())


def gt_plans(dev, n_timed: int = 3) -> dict:
    """GT CEM plans at the canonical config in LocobotPush: a warm-up and
    n_timed timed plans (median latency), each launching the mask kernel
    opt_iter times and the cell never, finite and shaped (horizon-1, 2)."""
    cfg = Config(**GT_CANONICAL)
    env = make("LocobotPush", cfg, seed=0, device=dev)
    goal = push_goal(env)
    policy = GTPushCEMPolicy(cfg, env)
    want = {"capsule_mask_render": cfg.opt_iter, "conv_lstm_cell": 0}
    seconds = []
    for i in range(n_timed + 1):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = policy.get_action(None, goal, ep_num=1, step=i)
        torch.cuda.synchronize()
        if i:
            seconds.append(time.perf_counter() - t0)
        got = {k: kernels.launches[k] - before[k] for k in want}
        if got != want:
            raise AssertionError(f"GT plan {i} launched {got}, expected {want}")
        if plan.shape != (cfg.horizon - 1, 2) or not np.all(np.isfinite(plan)):
            raise AssertionError(f"bad GT plan {plan!r}")
    return dict(policy=policy, goal=goal, seconds=seconds,
                latency=float(np.median(seconds)), launches=want)


def run_push_episode(cfg: Config, dev, model=None, demo_length: int = 6):
    """One PushEpisodeRunner episode on `dev` following an in-memory demo:
    (stats, per-step plan seconds, env step seconds, launches, the
    executed actions)."""
    runner = PushEpisodeRunner(cfg, model, device=dev)
    demo = push_demo(runner.env, demo_length)
    plan_s, step_s, actions = [], [], []
    policy, env = runner.policy, runner.env
    plan, step = policy.get_action, env.step

    def timed_plan(*a, **k):
        t0 = time.perf_counter()
        out = plan(*a, **k)  # returns numpy: the device has finished
        plan_s.append(time.perf_counter() - t0)
        return out

    def timed_step(a):
        t0 = time.perf_counter()
        out = step(a)
        step_s.append(time.perf_counter() - t0)
        actions.append(np.asarray(a, np.float32))
        return out

    policy.get_action, env.step = timed_plan, timed_step
    kernels.reset_launches()
    try:
        stats = runner.run_episode(0, demo)
    finally:
        runner.logger.close()
    return dict(stats=stats, plan_s=plan_s, step_s=step_s,
                launches=dict(kernels.launches), actions=np.stack(actions))


def bridge_plan_check(dev, fields=None, seed=5) -> dict:
    """The bridge to the reference's checkpoints on `dev`: a reference-
    layout state dict built on the host (a seeded model's export), loaded
    through torch_import, plans as the same weights loaded through
    convert.py (its JAX trees), bit for bit."""
    cfg = Config(**(CANONICAL if fields is None else fields))
    sd = torch_export.export_state_dict(svg.init(cfg, seed, "cpu"), cfg)
    bridged = torch_import.model_from_torch(cfg, sd, dev)
    converted = convert.model_from_jax(cfg, *torch_import.import_model(cfg, sd),
                                       device=dev)
    start, goal = start_goal(np.random.RandomState(0), cfg.image_height,
                             cfg.image_width)
    plans = [CEMPolicy(cfg, m, device=dev).get_action(start, goal, ep_num=3)
             for m in (bridged, converted)]
    return dict(keys=len(sd), equal=bool(np.array_equal(*plans)),
                max_diff=float(np.abs(plans[0] - plans[1]).max()))
