"""Robot control: the visual MPC controller, its socket bridge and ROS
adapter, AprilTag calibration (apriltag.py), plan serving, and the
episode runners (episode_runner.py)."""

from robot_aware_control_tpu_torch.control.plan_server import (
    PlanClient,
    PlanServer,
    RemotePolicy,
    build_server,
)
from robot_aware_control_tpu_torch.control.real_robot import (
    RobotBridgeServer,
    RobotInterface,
    SimRobotInterface,
    SocketRobotInterface,
    VisualMPCController,
)

__all__ = ["PlanClient", "PlanServer", "RemotePolicy", "build_server",
           "RobotBridgeServer", "RobotInterface", "SimRobotInterface",
           "SocketRobotInterface", "VisualMPCController"]
