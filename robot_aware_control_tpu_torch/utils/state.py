"""Planner state containers (reference: src/utils/state.py:4-18).

Images are HWC float [0,1] or uint8, matching the reference's conventions.
"""

from dataclasses import dataclass
from typing import Any


@dataclass
class State:
    img: Any = None        # current image observation
    state: Any = None      # robot eef state vector
    sim_state: Any = None  # flattened simulator state (gt-dynamics rollouts)
    mask: Any = None       # robot segmentation mask
    sim: Any = None        # simulator handle
    qpos: Any = None       # joint positions (analytical robot model)


@dataclass
class DemoGoalState:
    imgs: Any = None       # list of goal images
    states: Any = None     # list of goal eef states
    sim_states: Any = None
    masks: Any = None      # list of goal masks
    qposes: Any = None     # list of goal joint positions
