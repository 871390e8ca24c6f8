"""PushT environment, from scratch on the framework's own 2D physics engine
(the port's copy of the JAX package's ``envs/pusht.py``; its frames are drawn
by ``envs/raster.py`` instead of OpenCV, pixel for pixel the same).

Behavioral re-implementation of the reference's pymunk-based PushT
(env/pusht/pusht_env.py:34-428, pusht_image_env.py:7-64): same geometry
(512-world, radius-15 kinematic agent, scale-30 T block of two boxes, walls at
5/506 with radius 2), same PD controller (kp=100, kv=20) at 100 Hz sim / 10 Hz
control, same seeded reset distribution, same coverage reward
(area(goal ∩ block)/area(goal), success at 95%), same 96×96 RGB rendering with
the reference's color scheme, and the gymnasium-style API the runners consume.

Coverage is computed exactly via convex polygon clipping (the T is two
non-overlapping rectangles), replacing the reference's shapely dependency.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from unified_video_action_tpu_torch.envs import raster
from unified_video_action_tpu_torch.envs.physics2d import (
    Body,
    CircleShape,
    PolyShape,
    SegmentShape,
    Space,
    cross2,
    moment_for_poly,
    poly_centroid,
    _rot,
)

# reference colors (pygame.Color names), RGB
COLOR_BG = (255, 255, 255)
COLOR_GOAL = (144, 238, 144)      # LightGreen
COLOR_BLOCK = (119, 136, 153)     # LightSlateGray
COLOR_AGENT = (65, 105, 225)      # RoyalBlue
COLOR_WALL = (211, 211, 211)      # LightGray


def _clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman convex clipping. Vertices CCW."""
    output = list(subject)
    n = len(clip)
    for i in range(n):
        a, b = clip[i], clip[(i + 1) % n]
        edge = b - a
        input_list = output
        output = []
        if not input_list:
            break
        prev = input_list[-1]
        prev_in = cross2(edge, prev - a) >= 0
        for cur in input_list:
            cur_in = cross2(edge, cur - a) >= 0
            if cur_in:
                if not prev_in:
                    t = _line_intersect(prev, cur, a, b)
                    if t is not None:
                        output.append(t)
                output.append(cur)
            elif prev_in:
                t = _line_intersect(prev, cur, a, b)
                if t is not None:
                    output.append(t)
            prev, prev_in = cur, cur_in
    return np.asarray(output) if output else np.zeros((0, 2))


def _line_intersect(p1, p2, a, b):
    d1 = p2 - p1
    d2 = b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-12:
        return None
    t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
    return p1 + t * d1


def _poly_area(verts: np.ndarray) -> float:
    if len(verts) < 3:
        return 0.0
    x, y = verts[:, 0], verts[:, 1]
    return 0.5 * abs(float(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))))


def _ccw(verts: np.ndarray) -> np.ndarray:
    x, y = verts[:, 0], verts[:, 1]
    signed = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    return verts if signed > 0 else verts[::-1]


class PushTEnv:
    """State-observation PushT (gymnasium-style API: reset()->obs,info;
    step()->obs, reward, terminated, truncated, info)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 10}
    reward_range = (0.0, 1.0)

    # T-block geometry (reference add_tee, scale=30, length=4)
    SCALE = 30
    LENGTH = 4

    def __init__(
        self,
        legacy: bool = False,
        block_cog=None,
        damping: Optional[float] = None,
        render_action: bool = True,
        render_size: int = 96,
        reset_to_state: Optional[np.ndarray] = None,
        fix_goal: bool = True,
    ):
        self._seed: Optional[int] = None
        self.seed()
        self.window_size = 512
        self.render_size = render_size
        self.sim_hz = 100
        self.control_hz = 10
        self.k_p, self.k_v = 100.0, 20.0
        self.legacy = legacy
        self.block_cog = block_cog
        self.damping_override = damping
        self.render_action = render_action
        self.reset_to_state = reset_to_state
        self.fix_goal = fix_goal
        self.latest_action = None
        self.success_threshold = 0.95
        self.space: Optional[Space] = None
        self._background_key = None

        obs_high = np.array([512, 512, 512, 512, 2 * np.pi], dtype=np.float64)
        self.observation_space = _BoxSpace(np.zeros(5), obs_high)
        self.action_space = _BoxSpace(
            np.zeros(2, dtype=np.float64), np.full(2, 512.0, dtype=np.float64)
        )

    # -- gym plumbing -------------------------------------------------------

    def seed(self, seed: Optional[int] = None):
        if seed is None:
            seed = np.random.randint(0, 25536)
        self._seed = seed
        self.np_random = np.random.default_rng(seed)
        return [seed]

    def _block_vertices(self):
        s, l = self.SCALE, self.LENGTH
        verts1 = np.array(
            [(-l * s / 2, s), (l * s / 2, s), (l * s / 2, 0), (-l * s / 2, 0)],
            dtype=np.float64,
        )
        verts2 = np.array(
            [(-s / 2, s), (-s / 2, l * s), (s / 2, l * s), (s / 2, s)],
            dtype=np.float64,
        )
        return verts1, verts2

    def _setup(self):
        self.space = Space(damping=0.0)
        # walls (reference coordinates)
        wall_pts = [
            ((5, 506), (5, 5)),
            ((5, 5), (506, 5)),
            ((506, 5), (506, 506)),
            ((5, 506), (506, 506)),
        ]
        for a, b in wall_pts:
            self.space.segments.append(
                SegmentShape(np.asarray(a, float), np.asarray(b, float), 2.0)
            )

        # agent: kinematic circle
        self.agent = Body(
            position=np.array([256.0, 400.0]), kinematic=True
        )
        self.space.bodies.append(self.agent)
        self.agent_shape = CircleShape(self.agent, 15.0, friction=1.0)
        self.space.circles.append(self.agent_shape)

        # T block: two boxes, preserving the reference's inertia quirk
        verts1, verts2 = self._block_vertices()
        mass = 1.0
        inertia1 = moment_for_poly(mass, verts1)
        moment = inertia1 + inertia1  # reference uses vertices1 twice (:399-404)
        cog = (poly_centroid(verts1) + poly_centroid(verts2)) / 2
        self.block = Body(
            position=np.array([256.0, 300.0]),
            angle=0.0,
            mass=2 * mass,
            moment=moment,
            cog_local=cog,
        )
        if self.block_cog is not None:
            self.block.cog_local = np.asarray(self.block_cog, float)
        self.space.bodies.append(self.block)
        self.block_shapes = [
            PolyShape(self.block, verts1, friction=1.0),
            PolyShape(self.block, verts2, friction=1.0),
        ]
        self.space.polys.extend(self.block_shapes)
        if self.damping_override is not None:
            self.space.damping = self.damping_override

        if self.fix_goal:
            self.goal_pose = np.array([256.0, 256.0, np.pi / 4])
        else:
            x = np.random.uniform(156, 356)
            y = np.random.uniform(156, 356)
            angle = np.random.uniform(0, 2 * np.pi)
            self.goal_pose = np.array([x, y, angle])

    def reset(self, seed: Optional[int] = None, options=None):
        if seed is not None:
            self.seed(seed)
        self._setup()
        state = self.reset_to_state
        if state is None:
            rs = np.random.RandomState(seed=self._seed)
            state = np.array(
                [
                    rs.randint(50, 450),
                    rs.randint(50, 450),
                    rs.randint(100, 400),
                    rs.randint(100, 400),
                    rs.randn() * 2 * np.pi - np.pi,
                ]
            )
        self._set_state(state)
        self.latest_action = None
        return self._get_obs(), self._get_info()

    def _set_state(self, state):
        state = np.asarray(state, dtype=np.float64)
        self.agent.position = state[:2].copy()
        self.agent.velocity = np.zeros(2)
        if self.legacy:
            self.block.position = state[2:4].copy()
            self.block.angle = float(state[4])
        else:
            self.block.angle = float(state[4])
            self.block.position = state[2:4].copy()
        self.block.velocity = np.zeros(2)
        self.block.angular_velocity = 0.0
        self.space.step(1.0 / self.sim_hz)

    def get_phys_state(self):
        """Snapshot the full dynamic state (for planners / MPC rollouts) —
        including the agent's angular state, which friction contacts can
        spin up during rollouts (restore must be side-effect free)."""
        return (
            self.agent.position.copy(),
            self.agent.velocity.copy(),
            self.block.position.copy(),
            float(self.block.angle),
            self.block.velocity.copy(),
            float(self.block.angular_velocity),
            float(self.agent.angle),
            float(self.agent.angular_velocity),
        )

    def set_phys_state(self, s) -> None:
        self.agent.position = s[0].copy()
        self.agent.velocity = s[1].copy()
        self.block.position = s[2].copy()
        self.block.angle = s[3]
        self.block.velocity = s[4].copy()
        self.block.angular_velocity = s[5]
        if len(s) > 6:  # older snapshots lack the agent angular state
            self.agent.angle = s[6]
            self.agent.angular_velocity = s[7]
        else:
            self.agent.angle = 0.0
            self.agent.angular_velocity = 0.0

    def step_dynamics(self, action) -> None:
        """One control step of pure dynamics — no reward/coverage/termination
        bookkeeping. Used by planner rollouts (pusht_expert MPC) where the
        coverage polygon clipping would dominate the rollout cost."""
        dt = 1.0 / self.sim_hz
        n_steps = self.sim_hz // self.control_hz
        action = np.asarray(action, dtype=np.float64)
        for _ in range(n_steps):
            acceleration = self.k_p * (action - self.agent.position) + self.k_v * (
                -self.agent.velocity
            )
            self.agent.velocity = self.agent.velocity + acceleration * dt
            self.space.step(dt)

    def step(self, action):
        dt = 1.0 / self.sim_hz
        self.space.n_contact_points = 0
        n_steps = self.sim_hz // self.control_hz
        if action is not None:
            action = np.asarray(action, dtype=np.float64)
            self.latest_action = action
            for _ in range(n_steps):
                acceleration = self.k_p * (action - self.agent.position) + self.k_v * (
                    -self.agent.velocity
                )
                self.agent.velocity = self.agent.velocity + acceleration * dt
                self.space.step(dt)

        coverage = self._coverage()
        reward = float(np.clip(coverage / self.success_threshold, 0, 1))
        terminated = bool(coverage > self.success_threshold)
        return self._get_obs(), reward, terminated, False, self._get_info()

    # -- geometry helpers ---------------------------------------------------

    def _block_world_polys(self, pose=None):
        verts1, verts2 = self._block_vertices()
        if pose is None:
            pos, angle = self.block.position, self.block.angle
        else:
            pos, angle = np.asarray(pose[:2], float), float(pose[2])
        R = _rot(angle)
        return [pos + verts1 @ R.T, pos + verts2 @ R.T]

    def _coverage(self) -> float:
        goal_polys = [_ccw(p) for p in self._block_world_polys(self.goal_pose)]
        block_polys = [_ccw(p) for p in self._block_world_polys()]
        goal_area = sum(_poly_area(p) for p in goal_polys)
        inter = 0.0
        for g in goal_polys:
            for b in block_polys:
                inter += _poly_area(_clip_polygon(b, g))
        return inter / max(goal_area, 1e-9)

    def _get_obs(self):
        return np.array(
            [
                *self.agent.position,
                *self.block.position,
                self.block.angle % (2 * np.pi),
            ]
        )

    def _get_info(self):
        n_steps = self.sim_hz // self.control_hz
        return {
            "pos_agent": np.array(self.agent.position),
            "vel_agent": np.array(self.agent.velocity),
            "block_pose": np.array([*self.block.position, self.block.angle]),
            "goal_pose": self.goal_pose,
            "n_contacts": int(
                np.ceil(self.space.n_contact_points / n_steps)
            ),
        }

    # -- rendering ----------------------------------------------------------

    def render(self, mode: str = "rgb_array"):
        return self._render_frame(mode)

    def _background(self) -> np.ndarray:
        """The goal pose under the walls at window size (RGB): what every
        frame draws first, cached per goal pose."""
        key = self.goal_pose.tobytes()
        if self._background_key != key:
            ws = self.window_size
            img = np.full((ws, ws, 3), 255, dtype=np.uint8)
            for p in self._block_world_polys(self.goal_pose):
                raster.fill_poly(img, np.round(p).astype(np.int32), COLOR_GOAL)
            for seg in self.space.segments:
                raster.thick_line(
                    img,
                    np.round(seg.a).astype(int),
                    np.round(seg.b).astype(int),
                    COLOR_WALL,
                    int(2 * seg.radius),
                )
            self._background_img, self._background_key = img, key
        return self._background_img

    def _render_frame(self, mode: str):
        if self.render_action and self.latest_action is not None:
            raise NotImplementedError(
                "the action marker (cv2.drawMarker) is not ported; "
                "construct the env with render_action=False"
            )
        img = self._background().copy()
        # block, then the agent over it
        for p in self._block_world_polys():
            raster.fill_poly(img, np.round(p).astype(np.int32), COLOR_BLOCK)
        raster.fill_circle(
            img,
            np.round(self.agent.position).astype(int),
            int(self.agent_shape.radius),
            COLOR_AGENT,
        )
        return raster.resize_linear_u8(img, (self.render_size, self.render_size))

    def close(self):
        pass


class PushTImageEnv(PushTEnv):
    """Image-observation variant: obs = {image (3,96,96) float[0,1], agent_pos}."""

    def __init__(self, legacy=False, block_cog=None, damping=None,
                 render_size=96, fix_goal=True):
        super().__init__(
            legacy=legacy, block_cog=block_cog, damping=damping,
            render_size=render_size, render_action=False, fix_goal=fix_goal,
        )

    def _get_obs(self):
        img = super()._render_frame(mode="rgb_array")
        agent_pos = np.array(self.agent.position, dtype=np.float32)
        return {
            "image": np.moveaxis(img.astype(np.float32) / 255, -1, 0),
            "agent_pos": agent_pos,
        }

    def render(self, mode: str = "rgb_array"):
        raise NotImplementedError(
            "the image env's render() returns the frame with the action marker "
            "(cv2.drawMarker), which is not ported with video recording"
        )


class _BoxSpace:
    """Tiny stand-in for gym.spaces.Box (runners only need shape/sample)."""

    def __init__(self, low, high):
        self.low = np.asarray(low)
        self.high = np.asarray(high)
        self.shape = self.low.shape

    def sample(self, rng=None):
        rng = rng or np.random
        return rng.uniform(self.low, self.high)
