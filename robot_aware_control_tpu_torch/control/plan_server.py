"""Planning as a service: a warm CEM planner on the GPU behind a TCP socket.

Counterpart of `robot_aware_control_tpu/control/plan_server.py`. One server
process on the GPU host holds the model and its planner, and any number of
robot-side clients send (start, goal) and receive the planned action
sequence. The wire protocol is the robot bridge's JSON-header +
float32-payload framing (control/real_robot.py), extended to multi-array
messages, byte for byte the JAX package's: a numpy client of either
package talks to a server of either, and a client needs only numpy and the
standard library.

Requests that queue behind an in-flight plan are micro-batched: the
handler thread that next takes the plan lock plans every queued request
together (CEMPolicy.get_action_batched, one rollout of R x N candidates per
CEM iteration). A request's plan is the same bits whether it is planned
alone or with others (planning/cem.py): the planner's kernels give each
row a result that depends on that row alone, its convolutions take each
request's rows apart, and its costs, top-k and refit run per request; so
the server keeps the cell kernel on both paths. `RemotePolicy` is a
drop-in for CEMPolicy's `get_action`.

    python -m robot_aware_control_tpu_torch.control.plan_server \\
        --dynamics_model_ckpt ckpt_N.npz --plan_server_port 7000 [--device cpu]
"""

from __future__ import annotations

import argparse
import socket
import threading
import time
from typing import Optional

import numpy as np

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control.real_robot import _recv_msg, _send_msg
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State


# --------------------------------------------------------------------------
# Multi-array framing on top of the bridge protocol: ONE message whose
# payload is the concatenation of float32-flattened arrays in sorted key
# order; the header carries {"arrays": {name: shape}} for reassembly.
# --------------------------------------------------------------------------

def _send_arrays(sock, header: dict, arrays: dict):
    arrays = {k: np.ascontiguousarray(v, np.float32)
              for k, v in arrays.items() if v is not None}
    header = dict(header, arrays={k: list(v.shape) for k, v in arrays.items()})
    blob = b"".join(arrays[k].tobytes() for k in sorted(arrays))
    _send_msg(sock, dict(header, shape=[len(blob) // 4]),
              np.frombuffer(blob, np.float32) if blob else None)


def _recv_arrays(sock):
    header, payload = _recv_msg(sock)
    arrays = {}
    off = 0
    for k in sorted(header.get("arrays", {})):
        shape = header["arrays"][k]
        n = int(np.prod(shape)) if shape else 1
        arrays[k] = payload[off:off + n].reshape(shape)
        off += n
    return header, arrays


class PlanServer:
    """GPU-host side: holds one warm policy and serves plan requests.

    Commands: "ping" (liveness), "info" (plan config), "plan" (start/goal
    arrays -> action plan), "close" (end this client session), "shutdown"
    (stop the server). `serve_forever` gives each client a handler thread;
    plans serialize on the one device, micro-batched unless
    batch_plans=False."""

    def __init__(self, cfg: Config, model, policy_cls=None,
                 host: str = "127.0.0.1", port: int = 0,
                 batch_plans: bool = True, device="cuda", **policy_kw):
        from robot_aware_control_tpu_torch.planning.cem import CEMPolicy

        self.cfg = cfg
        # Served-plan consistency: with micro-batching on, a request's plan
        # must not depend on what else was queued with it. The cell kernel
        # and the mask kernel give each row a result of its own inputs
        # alone; the autograd cell (fused_lstm false) runs cuDNN, whose
        # algorithm may change with the batch, so a batching server plans
        # with the kernel on both paths.
        plan_cfg = cfg
        self.consistent_cells = bool(batch_plans) and not cfg.fused_lstm
        if self.consistent_cells:
            plan_cfg = cfg.replace(fused_lstm=True)
        self.policy = (policy_cls or CEMPolicy)(plan_cfg, model,
                                                device=device, **policy_kw)
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()
        self._shutdown = False
        self._requests = 0
        # one device; concurrent client threads serialize planning
        self._plan_lock = threading.Lock()
        # leader-follower micro-batching: requests that queue up behind an
        # in-flight plan are planned together by whichever handler thread
        # takes the plan lock next
        self._batch_plans = bool(batch_plans)
        self._q_lock = threading.Lock()
        self._q: list = []

    # --- request handling -------------------------------------------------
    @staticmethod
    def _decode_request(header: dict, arrays: dict):
        start = State(
            img=arrays["start_img"],
            state=arrays["start_state"],
            qpos=arrays.get("start_qpos"),
        )
        masks = arrays.get("goal_masks")
        states = arrays.get("goal_states")
        goal = DemoGoalState(
            imgs=list(arrays["goal_imgs"]),
            masks=None if masks is None else list(masks),
            states=None if states is None else list(states),
        )
        return (start, goal, int(header.get("ep_num", 0)),
                int(header.get("step", 0)), arrays.get("opt_traj"))

    def _handle_plan(self, header: dict, arrays: dict) -> tuple:
        """Plans one request. With batching, the handler thread that wins
        the plan lock drains every queued request and plans them together;
        the others wake up to a filled slot."""
        if not self._batch_plans:
            with self._plan_lock:
                start, goal, ep, st, opt = self._decode_request(header, arrays)
                t0 = time.perf_counter()
                plan = self.policy.get_action(start, goal, ep_num=ep,
                                              step=st, opt_traj=opt)
                self._requests += 1
                return (np.asarray(plan, np.float32),
                        time.perf_counter() - t0, 1)

        slot = {"done": threading.Event()}
        with self._q_lock:
            self._q.append((header, arrays, slot))
        with self._plan_lock:
            if not slot["done"].is_set():
                with self._q_lock:
                    batch, self._q = self._q, []
                self._plan_batch(batch)
        slot["done"].wait()
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot["plan"], slot["dt"], slot["batch"]

    def _plan_batch(self, batch: list):
        """Plans a drained batch, grouped by goal structure
        (get_action_batched requires consistent masks/states presence)."""
        groups: dict = {}
        for header, arrays, slot in batch:
            key = ("goal_masks" in arrays, "goal_states" in arrays)
            groups.setdefault(key, []).append((header, arrays, slot))
        for reqs in groups.values():
            t0 = time.perf_counter()
            try:
                dec = [self._decode_request(h, a) for h, a, _ in reqs]
                plans = self.policy.get_action_batched(
                    [d[0] for d in dec], [d[1] for d in dec],
                    ep_nums=[d[2] for d in dec], steps=[d[3] for d in dec],
                    opt_trajs=[d[4] for d in dec],
                )
                dt = time.perf_counter() - t0
                for (_, _, slot), plan in zip(reqs, plans):
                    slot["plan"] = np.asarray(plan, np.float32)
                    slot["dt"] = dt
                    slot["batch"] = len(reqs)
                self._requests += len(reqs)
            except Exception as e:
                for _, _, slot in reqs:
                    slot["error"] = str(e)
            finally:
                for _, _, slot in reqs:
                    slot["done"].set()

    def info(self) -> dict:
        p = self.policy
        return {
            "ok": True,
            "model": self.cfg.model,
            "horizon": p.horizon,
            "opt_iter": p.opt_iter,
            "action_candidates": p.num_candidates,
            "action_dim": p.action_dim,
            "plan_quantize": self.cfg.plan_quantize,
            # what the planner runs: the cell kernel (its plain version on
            # the CPU) or the autograd cell
            "fused_lstm": bool(p.cfg.fused_lstm),
            "batch_plans": self._batch_plans,
            "consistent_cells": self.consistent_cells,
            "device": str(p.device),
            "requests": self._requests,
        }

    def _handle_conn(self, conn):
        """One client session: request/response until close/shutdown/EOF."""
        try:
            while True:
                header, arrays = _recv_arrays(conn)
                cmd = header.get("cmd")
                if cmd == "close":
                    _send_msg(conn, {"ok": True})
                    return
                if cmd == "shutdown":
                    self._shutdown = True
                    _send_msg(conn, {"ok": True})
                    # close() alone does not wake a thread blocked in
                    # accept() on Linux: shut the listening socket down first
                    try:
                        self._srv.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    self._srv.close()
                    return
                try:
                    if cmd == "ping":
                        _send_msg(conn, {"ok": True, "requests": self._requests})
                    elif cmd == "info":
                        _send_msg(conn, self.info())
                    elif cmd == "plan":
                        plan, dt, nbatch = self._handle_plan(header, arrays)
                        _send_arrays(conn, {"ok": True,
                                            "plan_s": round(dt, 4),
                                            "batched": nbatch},
                                     {"plan": plan})
                    else:
                        _send_msg(conn, {"ok": False,
                                         "error": f"unknown cmd {cmd}"})
                except Exception as e:  # keep serving after a bad request
                    _send_msg(conn, {"ok": False, "error": str(e)})
        except (ConnectionError, OSError):
            pass  # client vanished
        finally:
            conn.close()

    def serve_once(self):
        """Serves one client connection to its end. Returns False once a
        client has asked the server to shut down."""
        conn, _ = self._srv.accept()
        self._handle_conn(conn)
        return not self._shutdown

    def serve_forever(self, concurrent: bool = True):
        """Accept loop. With `concurrent`, each client gets a handler
        thread (several robots share the planner)."""
        try:
            while not self._shutdown:
                conn, _ = self._srv.accept()
                if concurrent:
                    threading.Thread(target=self._handle_conn, args=(conn,),
                                     daemon=True).start()
                else:
                    self._handle_conn(conn)
        except OSError:
            pass  # listening socket closed (shutdown or close())

    def start(self) -> threading.Thread:
        """serve_forever on a daemon thread (tests, embedding)."""
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t

    def close(self):
        self._shutdown = True
        try:
            self._srv.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._srv.close()


class PlanClient:
    """Robot-host side: numpy + stdlib only."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self.last_plan_s: Optional[float] = None
        self.last_batched: Optional[int] = None  # co-planned request count

    def _call(self, cmd: str, header: dict = None, arrays: dict = None):
        _send_arrays(self._sock, dict(header or {}, cmd=cmd), arrays or {})
        resp, out = _recv_arrays(self._sock)
        if not resp.get("ok"):
            raise RuntimeError(f"plan server error for {cmd}: "
                               f"{resp.get('error')}")
        return resp, out

    def ping(self) -> dict:
        return self._call("ping")[0]

    def info(self) -> dict:
        return self._call("info")[0]

    def plan(self, start: State, goal: DemoGoalState, ep_num: int = 0,
             step: int = 0, opt_traj=None) -> np.ndarray:
        arrays = {
            "start_img": np.asarray(start.img, np.float32),
            "start_state": np.asarray(start.state, np.float32),
            "goal_imgs": np.stack(
                [np.asarray(g, np.float32) for g in goal.imgs]),
        }
        if start.qpos is not None:
            arrays["start_qpos"] = np.asarray(start.qpos, np.float32)
        if goal.masks is not None:
            arrays["goal_masks"] = np.stack(
                [np.asarray(m, np.float32) for m in goal.masks])
        if goal.states is not None:
            arrays["goal_states"] = np.stack(
                [np.asarray(s, np.float32) for s in goal.states])
        if opt_traj is not None:
            arrays["opt_traj"] = np.asarray(opt_traj, np.float32)
        resp, out = self._call("plan", {"ep_num": ep_num, "step": step},
                               arrays)
        self.last_plan_s = resp.get("plan_s")
        self.last_batched = resp.get("batched")
        return out["plan"]

    def close(self, shutdown_server: bool = False):
        try:
            self._call("shutdown" if shutdown_server else "close")
        finally:
            self._sock.close()


class RemotePolicy:
    """get_action-compatible facade over PlanClient, so a
    VisualMPCController can plan against a remote server unchanged."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._client = PlanClient(host, port, timeout=timeout)

    def get_action(self, start: State, goal: DemoGoalState, ep_num=0,
                   step=0, opt_traj=None, rng=None):
        if rng is not None:
            raise ValueError("RemotePolicy: rng is server-side (seeded from "
                             "cfg.seed + ep_num/step, planning/cem.py)")
        return self._client.plan(start, goal, ep_num=ep_num, step=step,
                                 opt_traj=opt_traj)

    def close(self, shutdown_server: bool = False):
        self._client.close(shutdown_server=shutdown_server)


def build_server(cfg: Config, device="cuda") -> PlanServer:
    """The listening PlanServer a config describes: the model from
    --dynamics_model_ckpt (a ckpt_<step>.npz of either package's trainer;
    random weights from cfg.seed without one), the policy class by --env,
    bound to --plan_server_host/--plan_server_port."""
    from robot_aware_control_tpu_torch.models.registry import load_model
    from robot_aware_control_tpu_torch.planning.cem import (
        CEMPolicy, PickCEMPolicy, PushCEMPolicy)

    model = load_model(cfg, cfg.dynamics_model_ckpt, device)
    policy_cls = {"LocobotPick": PickCEMPolicy,
                  "LocobotPush": PushCEMPolicy,
                  "LocobotTable": PushCEMPolicy}.get(cfg.env, CEMPolicy)
    return PlanServer(cfg, model, policy_cls=policy_cls,
                      host=cfg.plan_server_host, port=cfg.plan_server_port,
                      device=device)


def warm(server: PlanServer):
    """Plans one blank request, so that the first robot's request finds
    the kernels built and the GPU warm. Returns the seconds it took."""
    from robot_aware_control_tpu_torch.data.norm import LOCOBOT_LOW

    cfg = server.cfg
    h, w = cfg.image_height, cfg.image_width
    # states normalize against the (5-d) locobot-frame bounds for every
    # robot (reference: trajectory_sampler.py:94-98)
    state_dim = min(cfg.robot_dim, len(LOCOBOT_LOW))
    t0 = time.perf_counter()
    server.policy.get_action(
        State(img=np.zeros((h, w, 3), np.float32),
              state=np.zeros(state_dim, np.float32),
              qpos=np.zeros(cfg.robot_joint_dim, np.float32)),
        DemoGoalState(imgs=[np.zeros((h, w, 3), np.float32)],
                      masks=[np.zeros((h, w), np.float32)]),
        ep_num=0, step=0)
    return time.perf_counter() - t0


def main(argv=None):
    """Load the checkpoint, warm the planner, serve until shutdown."""
    from robot_aware_control_tpu_torch.config import argparser

    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--device", default="cuda",
                     help="cuda (default) or cpu; there is no fallback")
    args, rest = pre.parse_known_args(argv)
    cfg, unparsed = argparser(rest)
    if unparsed:
        raise ValueError(f"unknown flags: {unparsed}")
    server = build_server(cfg, device=args.device)
    print(f"plan server: {cfg.model} policy={type(server.policy).__name__} "
          f"on {args.device}, listening on "
          f"{server.address[0]}:{server.address[1]}", flush=True)
    print(f"plan server: warm ({warm(server):.1f} s)", flush=True)
    server.serve_forever()
    server.close()


if __name__ == "__main__":
    main()
