"""Geometric planning helpers: RRT, planar RRT, collision checks.

The port's copy of `robot_aware_control_tpu/utils/planning_geom.py` (numpy
only). Reference parity: src/env/robotics/rrt.py, planar_rrt.py, collision.py —
sampling-based planners used by scripted demo generation to route the eef
around objects. Numpy host-side (planning happens once per demo, not on the
hot path).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def segment_sphere_collision(p0, p1, center, radius) -> bool:
    """Does segment p0->p1 pass within radius of center?"""
    p0, p1, c = (np.asarray(x, np.float64) for x in (p0, p1, center))
    d = p1 - p0
    L2 = float(d @ d)
    if L2 < 1e-12:
        return float(np.linalg.norm(p0 - c)) <= radius
    t = float(np.clip((c - p0) @ d / L2, 0.0, 1.0))
    return float(np.linalg.norm(p0 + t * d - c)) <= radius


def point_in_aabb(p, low, high) -> bool:
    p = np.asarray(p)
    return bool(np.all(p >= np.asarray(low)) and np.all(p <= np.asarray(high)))


class RRT:
    """Minimal RRT over a box workspace with a collision callback
    (reference: rrt.py). Works in any dimension; `planar_rrt` is the 2-D
    specialization."""

    def __init__(self, low, high,
                 collision_fn: Optional[Callable] = None,
                 step_size: float = 0.03, max_iters: int = 2000,
                 goal_bias: float = 0.1, seed: int = 0):
        self.low = np.asarray(low, np.float64)
        self.high = np.asarray(high, np.float64)
        self.collision = collision_fn or (lambda a, b: False)
        self.step = step_size
        self.max_iters = max_iters
        self.goal_bias = goal_bias
        self.rng = np.random.RandomState(seed)

    def plan(self, start, goal, tol: float = 0.02) -> Optional[List[np.ndarray]]:
        start = np.asarray(start, np.float64)
        goal = np.asarray(goal, np.float64)
        nodes = [start]
        parents = [-1]
        for _ in range(self.max_iters):
            target = goal if self.rng.rand() < self.goal_bias else \
                self.rng.uniform(self.low, self.high)
            d = np.linalg.norm(np.stack(nodes) - target, axis=-1)
            ni = int(np.argmin(d))
            direction = target - nodes[ni]
            n = np.linalg.norm(direction)
            if n < 1e-9:
                continue
            new = nodes[ni] + direction / n * min(self.step, n)
            if self.collision(nodes[ni], new):
                continue
            nodes.append(new)
            parents.append(ni)
            if np.linalg.norm(new - goal) < tol and not self.collision(new, goal):
                nodes.append(goal)
                parents.append(len(nodes) - 2)
                # backtrack
                path = [len(nodes) - 1]
                while parents[path[-1]] != -1:
                    path.append(parents[path[-1]])
                return [nodes[i] for i in reversed(path)]
        return None


class CollisionObject:
    """Parametric collision object (reference: collision.py:6-19)."""

    def in_collision(self, target) -> bool:  # pragma: no cover - interface
        raise NotImplementedError


class CollisionBox(CollisionObject):
    """N-d axis-aligned box; boundary counts as collision
    (reference: collision.py:22-43)."""

    def __init__(self, location, half_lengths):
        self.location = np.asarray(location, np.float64)
        self.half_lengths = np.asarray(half_lengths, np.float64)
        self.ndim = self.location.shape[0]

    def in_collision(self, target) -> bool:
        t = np.asarray(target, np.float64)
        return bool(np.all(np.abs(t - self.location) <= self.half_lengths))


class CollisionSphere(CollisionObject):
    """N-d sphere (reference: collision.py:46-71)."""

    def __init__(self, location, radius):
        self.location = np.asarray(location, np.float64)
        self.radius = float(radius)

    def in_collision(self, target) -> bool:
        return bool(
            np.linalg.norm(np.asarray(target) - self.location) <= self.radius
        )

    def line_in_collision(self, o, u) -> bool:
        """Infinite-line/sphere discriminant test
        (reference: collision.py:61-71)."""
        o = np.asarray(o, np.float64)
        u = np.asarray(u, np.float64)
        c, r = self.location, self.radius
        delta = (u @ (o - c)) ** 2 - (np.linalg.norm(o - c) ** 2 - r ** 2)
        return bool(delta >= 0)


def rrt_with_objects(start, goal, low, high, objects=(), step_size=0.03,
                     samples_per_edge: int = 5, **kw):
    """RRT over CollisionObject obstacles: edges are rejected when any
    sampled point along them lies inside an object (the reference's
    node-level in_collision applied along edges)."""

    def collide(a, b):
        for s in np.linspace(0.0, 1.0, samples_per_edge):
            p = (1 - s) * np.asarray(a) + s * np.asarray(b)
            if any(ob.in_collision(p) for ob in objects):
                return True
        return False

    return RRT(low, high, collision_fn=collide, step_size=step_size,
               **kw).plan(start, goal)


def planar_rrt(start_xy, goal_xy, low, high, obstacles=(),
               obstacle_radius: float = 0.06, **kw):
    """2-D RRT avoiding circular obstacles (reference: planar_rrt.py)."""
    obs = [np.asarray(o, np.float64) for o in obstacles]

    def collide(a, b):
        a3 = np.array([a[0], a[1], 0.0])
        b3 = np.array([b[0], b[1], 0.0])
        return any(
            segment_sphere_collision(a3, b3, np.array([o[0], o[1], 0.0]),
                                     obstacle_radius)
            for o in obs
        )

    return RRT(low, high, collision_fn=collide, **kw).plan(start_xy, goal_xy)
