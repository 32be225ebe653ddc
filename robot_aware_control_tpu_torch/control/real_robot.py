"""Visual MPC controller, hardware-agnostic, and its socket bridge.

Counterpart of `robot_aware_control_tpu/control/real_robot.py` (reference:
locobot_rospkg/nodes/visual_MPC_controller.py:60-437): capture a goal
image, drive the eef to the start pose, then loop CEM planning and action
execution (optionally open-loop, visual_MPC_controller.py:319-340). The
controller talks to a `RobotInterface` (camera frame, eef state and qpos,
action execution), so the same class drives a simulation env
(`SimRobotInterface`), a socket bridge to the robot host
(`RobotBridgeServer` / `SocketRobotInterface`) or the ROS adapter
(`ROSRobotInterface`, built by `make_ros_interface` on a host with rospy,
which raises without it). `calibrate_extrinsics` registers the camera
from an AprilTag on the arm (control/apriltag.py).

The wire protocol is the JAX package's, byte for byte: per message an
8-byte little-endian (header length, payload length), a JSON header, and a
raw little-endian float32 payload whose shape the header carries. The
robot side needs only numpy and the standard library.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Optional, Protocol

import numpy as np

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State


class RobotInterface(Protocol):
    """Minimal hardware surface the controller needs."""

    def get_image(self) -> np.ndarray: ...           # (H, W, 3) float [0,1]
    def get_eef_state(self) -> np.ndarray: ...       # (>=3,) world eef
    def get_qpos(self) -> np.ndarray: ...            # (>=4,) joints
    def execute_action(self, action: np.ndarray): ...
    def move_to(self, eef_target: np.ndarray): ...


class SimRobotInterface:
    """Drives a simulation env through the hardware surface: the test
    double for a robot. The env is duck-typed: render() -> (H, W, 3)
    image, state.eef (3,) and state.qpos, action_dim and step(action)."""

    def __init__(self, env):
        self.env = env

    def get_image(self):
        return self.env.render()

    def get_eef_state(self):
        return np.array([*np.asarray(self.env.state.eef), 0.0, 0.0], np.float32)

    def get_qpos(self):
        return np.asarray(self.env.state.qpos)

    def execute_action(self, action):
        d = self.env.action_dim
        a = np.zeros(d, np.float32)
        n = min(len(action), d)
        a[:n] = np.asarray(action, np.float32)[:n]
        self.env.step(a)

    def move_to(self, eef_target):
        d = self.env.action_dim
        for _ in range(20):
            eef = np.asarray(self.env.state.eef)
            delta = np.clip((np.asarray(eef_target)[:3] - eef) / 0.05, -1, 1)
            if np.linalg.norm(delta) * 0.05 < 0.01:
                break
            a = np.zeros(d, np.float32)
            n = min(3, d)
            a[:n] = delta[:n]
            self.env.step(a)


class VisualMPCController:
    """(reference: visual_MPC_controller.py:60-437). The policy is
    policy_cls(cfg, model, device=device, **policy_kw): a CEM policy, or a
    factory of control/plan_server.py:RemotePolicy to plan on a server."""

    def __init__(self, cfg: Config, robot: RobotInterface, model,
                 policy_cls=CEMPolicy, device="cuda", **policy_kw):
        self.cfg = cfg
        self.robot = robot
        self.policy = policy_cls(cfg, model, device=device, **policy_kw)
        self.goal: Optional[DemoGoalState] = None
        self.start_eef: Optional[np.ndarray] = None

    # --- setup phase (reference :226-314) -------------------------------
    def calibrate_extrinsics(self, camera_key: str, tag_T_base, K,
                             tag_size: float = 0.0353,
                             offset=(0.0, -0.015, 0.0125),
                             detector=None, codebook=None):
        """AprilTag camera calibration (reference get_cam_calibration /
        set_camera_calibration, visual_MPC_controller.py:152-219): grab a
        frame, detect the arm-mounted tag, compose camera-to-base from the
        FK tag pose, and register the extrinsics under `camera_key`
        (data/calibration.py:register_camera), so that every later mask
        render uses them. The defaults are the reference rig's tag size
        (:135) and measured position offset (:204). Returns the 4x4
        camera-to-base, or None where no tag is found."""
        from robot_aware_control_tpu_torch.control.apriltag import (
            calibrate_camera_from_tag,
        )

        return calibrate_camera_from_tag(
            camera_key, self.robot.get_image(), tag_T_base, K, tag_size,
            offset=offset, codebook=codebook, detector=detector)

    def collect_goal_img(self):
        """Capture the current camera frame as the goal."""
        img = self.robot.get_image()
        h, w = img.shape[:2]
        self.goal = DemoGoalState(
            imgs=[np.asarray(img, np.float32)],
            masks=[np.zeros((h, w), np.float32)],
        )
        return img

    def set_start_pose(self, eef_target):
        self.start_eef = np.asarray(eef_target, np.float32)
        self.robot.move_to(self.start_eef)

    def create_start_goal(self):
        img = self.robot.get_image()
        start = State(
            img=np.asarray(img, np.float32),
            state=self.robot.get_eef_state(),
            qpos=self.robot.get_qpos(),
        )
        assert self.goal is not None, "collect_goal_img() first"
        return start, self.goal

    # --- control loop (reference :319-340) -------------------------------
    def run(self, max_steps: Optional[int] = None):
        cfg = self.cfg
        steps = max_steps or cfg.max_episode_length
        executed = []
        t = 0
        while t < steps:
            start, goal = self.create_start_goal()
            plan = self.policy.get_action(start, goal, ep_num=0, step=t)
            if cfg.cem_open_loop:
                for action in plan:
                    self.robot.execute_action(action)
                    executed.append(action)
                    t += 1
                    if t >= steps:
                        break
            else:
                k = max(cfg.replan_every, 1)
                for action in plan[:k]:
                    self.robot.execute_action(action)
                    executed.append(action)
                    t += 1
        return np.asarray(executed)


# --------------------------------------------------------------------------
# Socket bridge: the planner on the GPU host and the robot driver on the
# robot host, connected by TCP: the network boundary the reference crosses
# with ROS topics and services (visual_MPC_controller.py:60-219).
# --------------------------------------------------------------------------

def _send_msg(sock, header: dict, payload: Optional[np.ndarray] = None):
    if payload is not None:
        payload = np.ascontiguousarray(payload, np.float32)
        header = dict(header, shape=list(payload.shape))
        raw = payload.tobytes()
    else:
        raw = b""
    head = json.dumps(header).encode()
    sock.sendall(struct.pack("<II", len(head), len(raw)) + head + raw)


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("robot bridge closed")
        buf += chunk
    return buf


def _recv_msg(sock):
    hlen, plen = struct.unpack("<II", _recv_exact(sock, 8))
    header = json.loads(_recv_exact(sock, hlen).decode())
    payload = None
    if plen:
        payload = np.frombuffer(_recv_exact(sock, plen), np.float32)
        payload = payload.reshape(header["shape"])
    return header, payload


class RobotBridgeServer:
    """Robot-host side: wraps any RobotInterface and serves it over TCP.
    `serve_once()` handles one controller connection to its end; a
    {"cmd": "close"} message ends the session."""

    def __init__(self, robot: RobotInterface, host: str = "127.0.0.1",
                 port: int = 0):
        self.robot = robot
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()

    def serve_once(self):
        conn, _ = self._srv.accept()
        try:
            while True:
                header, payload = _recv_msg(conn)
                cmd = header["cmd"]
                if cmd == "close":
                    _send_msg(conn, {"ok": True})
                    return
                try:
                    if cmd == "get_image":
                        _send_msg(conn, {"ok": True},
                                  np.asarray(self.robot.get_image()))
                    elif cmd == "get_eef_state":
                        _send_msg(conn, {"ok": True},
                                  np.asarray(self.robot.get_eef_state()))
                    elif cmd == "get_qpos":
                        _send_msg(conn, {"ok": True},
                                  np.asarray(self.robot.get_qpos()))
                    elif cmd == "execute_action":
                        self.robot.execute_action(payload)
                        _send_msg(conn, {"ok": True})
                    elif cmd == "move_to":
                        self.robot.move_to(payload)
                        _send_msg(conn, {"ok": True})
                    else:
                        _send_msg(conn, {"ok": False,
                                         "error": f"unknown cmd {cmd}"})
                except Exception as e:  # robot fault -> report, keep serving
                    _send_msg(conn, {"ok": False, "error": str(e)})
        finally:
            conn.close()

    def close(self):
        self._srv.close()


class SocketRobotInterface:
    """GPU-host side: a RobotInterface whose every call crosses the TCP
    bridge to a RobotBridgeServer on the robot host."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def _call(self, cmd: str, payload: Optional[np.ndarray] = None):
        _send_msg(self._sock, {"cmd": cmd}, payload)
        header, data = _recv_msg(self._sock)
        if not header.get("ok"):
            raise RuntimeError(
                f"robot bridge error for {cmd}: {header.get('error')}")
        return data

    def get_image(self) -> np.ndarray:
        return self._call("get_image")

    def get_eef_state(self) -> np.ndarray:
        return self._call("get_eef_state")

    def get_qpos(self) -> np.ndarray:
        return self._call("get_qpos")

    def execute_action(self, action: np.ndarray):
        self._call("execute_action", np.asarray(action, np.float32))

    def move_to(self, eef_target: np.ndarray):
        self._call("move_to", np.asarray(eef_target, np.float32))

    def close(self):
        try:
            self._call("close")
        finally:
            self._sock.close()


class ROSRobotInterface:
    """ROS adapter (reference: locobot_rospkg/nodes/
    visual_MPC_controller.py:60-219: RealSense image subscriber, eef
    service client, PyRobot command publisher). Built by
    `make_ros_interface` on a host with rospy; without ROS use
    SimRobotInterface or the socket bridge above."""

    def __init__(self, cfg: Config,
                 image_topic: str = "/camera/color/image_raw",
                 joint_topic: str = "/joint_states",
                 eef_topic: str = "/eef_pose"):
        import rospy
        from geometry_msgs.msg import PoseStamped, Twist
        from sensor_msgs.msg import Image, JointState

        self.cfg = cfg
        self._img = None
        self._qpos = None
        self._eef = None
        rospy.init_node("rac_tpu_visual_mpc", anonymous=True)
        rospy.Subscriber(image_topic, Image, self._on_image, queue_size=1)
        rospy.Subscriber(joint_topic, JointState, self._on_joints,
                         queue_size=1)
        rospy.Subscriber(eef_topic, PoseStamped, self._on_eef, queue_size=1)
        self._cmd_pub = rospy.Publisher("/rac_tpu/eef_delta", Twist,
                                        queue_size=1)
        self._twist = Twist
        self._rospy = rospy

    def _on_image(self, msg):
        h, w = msg.height, msg.width
        img = np.frombuffer(msg.data, np.uint8).reshape(h, w, -1)[..., :3]
        self._img = img.astype(np.float32) / 255.0

    def _on_joints(self, msg):
        self._qpos = np.asarray(msg.position, np.float32)

    def _on_eef(self, msg):
        p = msg.pose.position
        self._eef = np.array([p.x, p.y, p.z, 0.0, 0.0], np.float32)

    def _wait(self, attr):
        while getattr(self, attr) is None and not self._rospy.is_shutdown():
            self._rospy.sleep(0.05)
        return getattr(self, attr)

    def get_image(self):
        return self._wait("_img")

    def get_eef_state(self):
        return self._wait("_eef")

    def get_qpos(self):
        return self._wait("_qpos")

    def execute_action(self, action):
        t = self._twist()
        a = np.asarray(action, np.float32).ravel()
        t.linear.x, t.linear.y = float(a[0]), float(a[1])
        t.linear.z = float(a[2]) if len(a) > 2 else 0.0
        self._cmd_pub.publish(t)
        self._rospy.sleep(getattr(self.cfg, "real_robot_step_time", 0.5))

    def move_to(self, eef_target):
        for _ in range(40):
            eef = self.get_eef_state()
            delta = np.asarray(eef_target, np.float32)[:3] - eef[:3]
            if np.linalg.norm(delta) < 0.01:
                return
            self.execute_action(np.clip(delta, -0.05, 0.05))


def make_ros_interface(cfg: Config) -> ROSRobotInterface:
    """The ROS wiring, import-gated so that hosts without ROS never import
    rospy (reference node: visual_MPC_controller.py:60-219)."""
    try:
        import rospy  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "rospy not available — real-robot control requires a ROS host. "
            "Use SimRobotInterface, or SocketRobotInterface against a "
            "RobotBridgeServer running on the robot host."
        ) from e
    return ROSRobotInterface(cfg)
