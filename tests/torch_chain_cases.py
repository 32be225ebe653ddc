"""The chain robots' shared cases (not a test module; imports no JAX):
the small chain planning config, starts and goals of the chain
experiments, joint configurations across a chain's ranges, the tolerances
of the chain tests, and the band of pixels near a capsule's edge where two
float32 renders of the same joints may disagree. Used by
tests/test_torch_port_robots.py, tests/test_torch_port_gpu.py and
chip_smoke.py."""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.data.norm import LOCO_FRANKA_DIFF, LOCO_WX250S_DIFF
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State

CHAIN_EXPERIMENTS = ["control_franka", "control_wx250s"]
SHIFT = {"control_franka": LOCO_FRANKA_DIFF, "control_wx250s": LOCO_WX250S_DIFF}
DOF = {"control_franka": 7, "control_wx250s": 6}
# the planning config of bench.py cut to test size: g_dim 16, z_dim 4,
# N 6, horizon 3, opt_iter 2, float32
CHAIN_PLAN = dict(
    model="svg", g_dim=16, z_dim=4, image_height=48, image_width=64,
    action_dim=5, robot_dim=5, model_use_mask=True, model_use_future_mask=True,
    model_use_robot_state=True, reconstruction_loss="dontcare_l1",
    reward_type="dontcare", compute_dtype="float32", horizon=3, opt_iter=2,
    action_candidates=6, topk=2, cem_init_std=0.015, sample_mean=True,
)
# the parity plans take one CEM iteration: a refit's mean moves the next
# iteration's actions by float32 rounding, the IK's choice between starts
# that tie at rounding follows them, and a different arm pose makes a
# different mask and cost. Its candidates are the same bits in both runs.
CHAIN_PARITY_PLAN = dict(CHAIN_PLAN, opt_iter=1)
# IK tips of two runs, metres: the starts that reach a target end within
# about 1e-7 m of it
TIP_TOL = 1e-5
# a start decides the IK's joints when it beats the runner-up by this (m)
IK_MARGIN = 1e-4
# pixels this close to a capsule's edge may flip between float32 renders
MASK_EDGE_PX = 1e-3


def range_qpos(chain, n: int, seed: int, scale: float = 0.5) -> np.ndarray:
    """n joint configurations: each joint at its range's midpoint plus a
    uniform draw of +-scale of its half-span."""
    lo, hi = chain.jnt_range[:, 0], chain.jnt_range[:, 1]
    mid, span = 0.5 * (lo + hi), 0.5 * (hi - lo)
    r = np.random.RandomState(seed).uniform(-scale, scale, (n, chain.dof))
    return (mid + r * span).astype(np.float32)


def chain_start_goal(rng, experiment: str, h: int = 48, w: int = 64):
    """A start in the robot's own frame, 0.3 m out in the locobot frame
    (the policy shifts it back), its joints zero, and a 4-frame goal with
    masks."""
    xy = np.array([0.3, 0.0], np.float32) - SHIFT[experiment]
    start = State(img=rng.rand(h, w, 3).astype(np.float32),
                  state=np.array([xy[0], xy[1], 0.15, 0.0, 0.0], np.float32),
                  qpos=np.zeros(DOF[experiment], np.float32))
    goal = DemoGoalState(
        imgs=[rng.rand(h, w, 3).astype(np.float32) for _ in range(4)],
        masks=[(rng.rand(h, w) > 0.8).astype(np.float32) for _ in range(4)])
    return start, goal


@torch.no_grad()
def edge_band(env, qpos, px: float = MASK_EDGE_PX) -> np.ndarray:
    """(..., H, W, 1) bool: pixels within `px` of some capsule's edge in
    `env` (a ChainMaskEnv) at joints `qpos`, as the pixels that change
    between renders with every radius grown and shrunk by at least `px`
    pixels (by px times the farthest capsule point's depth over fx
    metres)."""
    q = torch.as_tensor(np.asarray(qpos, np.float32), device=env.device)
    a, b = env._capsule_endpoints(q, env._caps)
    z = env._project(torch.cat([a, b], -2))[2].max()
    d = px * float(z) / env._fx * 1.01
    occ = env.occluder_depth(q) if env.occlude else None
    grown = env.render_with(q, env.radii + d, env.ext, occ)
    shrunk = env.render_with(q, env.radii - d, env.ext, occ)
    return (grown != shrunk).cpu().numpy()


def chain_geometry(dev, keys=None) -> dict:
    """Every chain key (fetch occluded) on `dev` against the CPU: FK to
    1e-5 m; IK (60 iterations) from the seeds to 8 FK-made targets, `valid`
    everywhere, each best tip within TIP_TOL of its target wherever the
    CPU's is and within TIP_TOL of the CPU's distance everywhere; the thin
    and thick masks of the CPU's joints differing only within MASK_EDGE_PX
    of an edge. Not every target is reached within TIP_TOL in 60
    iterations: widowx's third ends 2.02e-5 m away from every start on the
    CPU, as in the JAX package (2.019e-5 m), and within 1.5e-8 m at 200.
    Returns {key: {"fk_err", "ik_tip_err", "ik_tip_err_cpu",
    "ik_start_err" and "ik_start_err_cpu" (each start's farthest target),
    "mask_differ", "mask_band"}}; raises AssertionError past a
    tolerance."""
    from robot_aware_control_tpu_torch.robot.kinematic_chain import (
        CHAINS,
        ChainMaskEnv,
    )

    out = {}
    for key in keys or sorted(CHAINS):
        chain = CHAINS[key]
        q = torch.tensor(range_qpos(chain, 16, seed=1, scale=0.8))
        pts = {d: chain.fk_points(q.to(d)).cpu() for d in ("cpu", dev)}
        fk_err = float((pts[dev] - pts["cpu"]).abs().max())
        targets = pts["cpu"][:8, -1]
        dist, start_err, valid = {}, {}, {}
        for d in ("cpu", dev):
            errs, _ = chain.ik_starts(targets.to(d))
            start_err[d] = errs.max(1).values.cpu().tolist()
            tq, valid[d] = chain.ik(targets.to(d))
            dist[d] = ((chain.fk_points(tq)[:, -1].cpu() - targets) ** 2).sum(-1).sqrt()
        row = dict(fk_err=fk_err, ik_tip_err=float(dist[dev].max()),
                   ik_tip_err_cpu=float(dist["cpu"].max()),
                   ik_start_err=start_err[dev], ik_start_err_cpu=start_err["cpu"],
                   mask_differ=0, mask_band=0)
        reached = dist["cpu"] < TIP_TOL
        if (fk_err > 1e-5 or not bool(valid[dev].all())
                or not bool((dist[dev][reached] < TIP_TOL).all())
                or float((dist[dev] - dist["cpu"]).abs().max()) > TIP_TOL):
            raise AssertionError(
                f"{key}: FK {fk_err:.3g}, IK tips {dist[dev].tolist()} "
                f"(CPU {dist['cpu'].tolist()}), each start's farthest "
                f"{start_err[dev]} (CPU {start_err['cpu']}), valid "
                f"{valid[dev].tolist()}")
        for thick in (False, True):
            envs = {d: ChainMaskEnv(key, thick=thick, device=d) for d in ("cpu", dev)}
            want = envs["cpu"].render(q).numpy()
            got = envs[dev].render(q.to(dev)).cpu().numpy()
            band = edge_band(envs["cpu"], q)
            differ = got != want
            row["mask_differ"] += int(differ.sum())
            row["mask_band"] += int(band.sum())
            if (differ & ~band).any() or not 0 < want.mean() < 1:
                raise AssertionError(f"{key} thick={thick}: {int(differ.sum())} "
                                     "mask pixels differ, some off an edge")
        out[key] = row
    return out


@torch.no_grad()
def chain_joints_parity(engine, start_raw, q0, acts) -> dict:
    """The chain planner's IK (engine.chain_joints: 20 iterations a step,
    warm-started from the previous step's joints) and its mask env on
    `engine`'s device against a CPU engine's on the same inputs: every
    step's tip within TIP_TOL of its target on both devices and of the
    CPU's distance; the masks of the device's joints equal to the CPU env's
    of the same joints but within MASK_EDGE_PX of an edge. The joints
    themselves are not compared: the redundant arms reach each target from
    several starts, and which one wins follows float32 rounding. Returns
    {"tips", "ik_tip_err", "ik_tip_err_cpu", "masks", "mask_differ",
    "mask_band"}; raises AssertionError past a tolerance."""
    from robot_aware_control_tpu_torch.planning.rollout import RolloutEngine

    cpu = RolloutEngine(engine.cfg, device="cpu")
    dist = {}
    for name, e, args in (("dev", engine, (start_raw, q0, acts)),
                          ("cpu", cpu, tuple(t.cpu() for t in (start_raw, q0, acts)))):
        xy, qs = e.chain_joints(*args)
        z = torch.full(xy.shape[:-1] + (1,), e.push_height, device=xy.device)
        target = torch.cat([xy - e.chain_shift, z], -1)
        dist[name] = ((e.chain.fk_points(qs)[..., -1, :] - target) ** 2).sum(-1).sqrt().cpu()
        if name == "dev":
            q_dev = qs
    got = engine.chain_env.render(q_dev).cpu().numpy()
    q_cpu = q_dev.cpu()
    differ = got != cpu.chain_env.render(q_cpu).numpy()
    band = edge_band(cpu.chain_env, q_cpu)
    out = dict(tips=int(dist["dev"].numel()), ik_tip_err=float(dist["dev"].max()),
               ik_tip_err_cpu=float(dist["cpu"].max()), masks=int(got[..., 0, 0, 0].size),
               mask_differ=int(differ.sum()), mask_band=int(band.sum()))
    if (out["ik_tip_err"] > TIP_TOL or out["ik_tip_err_cpu"] > TIP_TOL
            or float((dist["dev"] - dist["cpu"]).abs().max()) > TIP_TOL
            or (differ & ~band).any()):
        raise AssertionError(f"{engine.cfg.experiment}: chain joints on "
                             f"{engine.device} vs CPU: {out}")
    return out


def small_chain_plan_parity(experiment: str, dev, tol: float = 1e-4):
    """A small float32 chain plan (CHAIN_PARITY_PLAN, seed-3 weights,
    injected action noise) on `dev` against the CPU's, `dev`'s engine at
    the CPU's robot trajectory (the IK's choice between starts that tie at
    rounding differs between devices: tests/test_torch_port_robots.py);
    and the plan of `dev`'s own trajectory, finite and clamped. Call with
    TF32 off. Returns max |difference|; raises past `tol`."""
    from robot_aware_control_tpu_torch.config import Config
    from robot_aware_control_tpu_torch.models import svg
    from robot_aware_control_tpu_torch.planning.cem import CEMPolicy

    cfg = Config(**dict(CHAIN_PARITY_PLAN, experiment=experiment))
    start, goal = chain_start_goal(np.random.RandomState(1), experiment)
    noise = np.random.RandomState(2).randn(
        cfg.opt_iter, cfg.action_candidates, cfg.horizon - 1, 2)
    policies = {d: CEMPolicy(cfg, svg.init(cfg, seed=3, device=d), device=d)
                for d in ("cpu", dev)}
    own = policies[dev].get_action(start, goal, noise=noise)
    if own.shape != (cfg.horizon - 1, 2) or not np.all(np.isfinite(own)) or np.abs(own).max() > 0.05:
        raise AssertionError(f"{experiment}: bad plan {own!r}")
    cpu_robot_trajectory = policies["cpu"].engine.robot_trajectory

    def cpu_trajectory(start_state_norm, start_qpos, actions_tna):
        out = cpu_robot_trajectory(start_state_norm.cpu(), start_qpos.cpu(),
                                   actions_tna.cpu())
        return tuple(t.to(dev) for t in out)

    policies[dev].engine.robot_trajectory = cpu_trajectory
    plans = {d: p.get_action(start, goal, noise=noise) for d, p in policies.items()}
    err = float(np.abs(plans[dev] - plans["cpu"]).max())
    if not err <= tol:
        raise AssertionError(f"{experiment}: {dev} plan differs from the CPU's "
                             f"by {err}")
    return err


def chain_batched_diff(policy, experiment: str, R: int = 2) -> float:
    """get_action_batched of R chain requests against their single plans:
    the largest |difference| (0.0 when bit for bit)."""
    reqs = [chain_start_goal(np.random.RandomState(20 + r), experiment)
            for r in range(R)]
    batched = policy.get_action_batched([s for s, _ in reqs], [g for _, g in reqs],
                                        ep_nums=list(range(R)), steps=[5] * R)
    return max(float(np.abs(batched[r] - policy.get_action(
        s, g, ep_num=r, step=5)).max()) for r, (s, g) in enumerate(reqs))
