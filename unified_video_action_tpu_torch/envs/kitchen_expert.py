"""The scripted expert of the Franka-kitchen backend (the port's own copy of
the JAX package's ``envs/kitchen_expert.py``: ``Phase``, ``TASK_SCRIPTS``,
``TASK_SITE`` and ``KitchenExpert`` at :160-264).

It stands in for the reference's demonstration corpora (the reference trains
LIBERO from demo HDF5s,
dataset/libero_replay_image_dataset.py:315-439): multi-task training data
made by the same env the runner evaluates (``tools/gen_kitchen_demos.py``).

Control: FrankaKitchen's actions are desired joint velocities (9-d, rad/s:
gymnasium_robotics' franka_env.py ``_ctrl_velocity_limits``), so the expert
is a Cartesian position servo through damped-least-squares inverse
kinematics on the 7 arm joints:

    qdot = Jp^T (Jp Jp^T + lambda^2 I)^-1 v_des

with an integral z term against the arm's steady gravity sag (the
position-servo actuators track the integrated velocity target, so a constant
downward error builds up on long horizontal reaches).

Each task is a short script of phases over the model's named task sites
(``knob*_site``, ``light_site``, ``slide_site``, ``hinge_site*``,
``microhandle_site``, ``kettle_site``): approach, engage, then push or pull
the way that drives the object's joint toward its ``OBS_ELEMENT_GOALS``
target. A phase aimed at a site chases it: the site moves with the object,
so a constant offset keeps dragging the object along its articulation (a
door's arc, a slide's rail) with no orientation control. The expert's noise
comes from ``np.random.default_rng(seed)``, as in JAX. ``mujoco`` is imported
where an expert is built.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np


@dataclass
class Phase:
    """One servo segment.

    target(site_pos) -> world goal for the end-effector; the phase ends
    when the EE is within ``tol`` of the goal or after ``max_steps``.
    ``grip``: +1 open, -1 close (finger velocity command).
    ``hold``: run exactly ``max_steps`` steps (ignore tol) — used for
    push/pull strokes where contact stops the hand short of the target.
    """

    target: Callable[[np.ndarray], np.ndarray]
    tol: float = 0.05
    max_steps: int = 60
    grip: float = 1.0
    hold: bool = False
    gain: float = 4.0
    vmax: float = 0.35
    #: hinge-chase: (joint_name, dq_sign, tangent_lead_m, radial_bias_m).
    #: Overrides ``target``: aim at site + lead * (arc tangent toward
    #: dq_sign) + radial bias (negative = toward the hinge anchor, i.e.
    #: pressing the hook against the handle as the door turns).
    hinge: Optional[tuple] = None


def _off(dx, dy, dz):
    o = np.array([dx, dy, dz], np.float64)
    return lambda p: p + o


#: per-task phase scripts, tuned against the actual kitchen scene geometry
#: (site positions at reset — see artifacts/round4/kitchen_sites.txt).
#: Conventions: +y is into the scene (toward the appliances), +x right.
TASK_SCRIPTS = {
    # slide door opens toward +x (slide_cabinet goal +0.37): hook the hand
    # just left of the handle, then chase a point right of the handle.
    "slide cabinet": lambda: [
        Phase(_off(-0.10, -0.16, 0.0), tol=0.06, max_steps=70),
        Phase(_off(-0.07, -0.02, 0.0), tol=0.04, max_steps=40),
        Phase(_off(0.18, -0.02, 0.0), hold=True, max_steps=80, vmax=0.30),
    ],
    # light switch: a ~3 cm toggle rotating about z (goal -0.69 rad moves
    # the tip ~5 cm toward -x). Come from above-right with closed fingers
    # (a frontal approach presses into the panel and the arm sags), then
    # sweep across at the tip's height.
    "light switch": lambda: [
        Phase(_off(0.08, -0.10, 0.14), tol=0.06, max_steps=70),
        Phase(_off(0.055, -0.02, 0.01), tol=0.035, max_steps=45, grip=-1.0),
        Phase(_off(-0.18, -0.02, 0.01), hold=True, max_steps=90, grip=-1.0,
              vmax=0.25),
    ],
    # microwave door hinges open toward the robot (goal -0.75 rad): hook
    # the closed fist BEHIND the handle bar (descend into
    # the gap between bar and door face), then pull along the opening arc
    # (handle sweeps (-0.64,0.49)->(-0.75,0.15) as microjoint -> -0.75).
    "microwave": lambda: [
        Phase(_off(0.0, -0.12, 0.16), tol=0.06, max_steps=70),
        Phase(_off(0.0, 0.03, 0.10), tol=0.045, max_steps=45, grip=-1.0),
        Phase(_off(0.0, 0.03, 0.0), hold=True, max_steps=25, grip=-1.0,
              vmax=0.25),
        # chase the opening arc: tangent computed live from the hinge's
        # world axis/anchor (fixed offsets slip off as the handle rotates);
        # +z offset keeps the hook at bar height against pull-down sag
        Phase(_off(0, 0, 0.06), hinge=("microwave", -1.0, 0.10, -0.04),
              hold=True, max_steps=170, grip=-1.0, vmax=0.16),
    ],
    # kettle: straddle the handle from above, close, drag to the back
    # burner goal (OBS_ELEMENT_GOALS kettle xyz = -0.23, 0.75, 1.62).
    "kettle": lambda: [
        Phase(_off(0.0, 0.0, 0.22), tol=0.06, max_steps=70),
        Phase(_off(0.0, 0.0, 0.05), tol=0.035, max_steps=45),
        Phase(_off(0.0, 0.0, 0.04), hold=True, max_steps=12, grip=-1.0),
        Phase(lambda p: np.array([-0.23, 0.75, 1.80]), tol=0.06,
              max_steps=90, grip=-1.0, vmax=0.30),
        Phase(lambda p: np.array([-0.23, 0.75, 1.70]), hold=True,
              max_steps=30, grip=-1.0),
        Phase(lambda p: np.array([-0.23, 0.75, 1.72]), hold=True,
              max_steps=10, grip=1.0),
    ],
    # burner knobs rotate about the stove-panel normal (goal ~ -0.9 rad):
    # poke the knob nub with closed fingers and chase the rotation arc.
    "bottom burner": lambda: [  # knob_Joint_2 drives the bottom-left pair
        Phase(_off(0.0, -0.14, 0.10), tol=0.05, max_steps=70),
        Phase(_off(0.0, -0.02, 0.01), tol=0.035, max_steps=45, grip=-1.0),
        Phase(_off(0, 0, 0), hinge=("knob_Joint_2", -1.0, 0.05, -0.015),
              hold=True, max_steps=120, grip=-1.0, vmax=0.18),
    ],
    "top burner": lambda: [  # knob_Joint_4 drives the top-left pair
        Phase(_off(0.0, -0.14, 0.10), tol=0.05, max_steps=70),
        Phase(_off(0.0, -0.02, 0.01), tol=0.035, max_steps=45, grip=-1.0),
        Phase(_off(0, 0, 0), hinge=("knob_Joint_4", -1.0, 0.05, -0.015),
              hold=True, max_steps=120, grip=-1.0, vmax=0.18),
    ],
    # hinge cabinet: right door swings open toward front-right (site arc
    # (-0.53,0.58)->(-0.13,0.40) as right_hinge goes 0 -> 1.45 rad).
    # Straddle the door edge with open fingers, close, chase the arc.
    "hinge cabinet": lambda: [
        Phase(_off(0.0, -0.12, 0.16), tol=0.06, max_steps=70),
        Phase(_off(0.0, 0.03, 0.10), tol=0.045, max_steps=45, grip=-1.0),
        Phase(_off(0.0, 0.03, -0.03), hold=True, max_steps=30, grip=-1.0,
              vmax=0.25),
        Phase(_off(0, 0, 0), hinge=("right_hinge_cabinet", 1.0, 0.16, -0.02),
              hold=True, max_steps=150, grip=-1.0, vmax=0.28),
    ],
}

#: which model site anchors each task's phase targets
TASK_SITE = {
    "slide cabinet": "slide_site",
    "light switch": "light_site",
    "microwave": "microhandle_site",
    "kettle": "kettle_site",
    "bottom burner": "knob2_site",
    "top burner": "knob4_site",
    "hinge cabinet": "hinge_site2",
}


class KitchenExpert:
    """Phase-scripted DLS-IK expert for one kitchen subtask.

    Drives a raw ``KitchenImageEnv`` (or any FrankaKitchen-v1 wrapper
    exposing ``.unwrapped``): call :meth:`act` each step for a 9-dim
    action. ``done`` turns True when the script is exhausted.
    """

    def __init__(self, env, task: str, noise: float = 0.0,
                 seed: Optional[int] = None):
        import mujoco

        self._mujoco = mujoco
        u = env._env.unwrapped if hasattr(env, "_env") else env.unwrapped
        self.m = u.robot_env.model
        self.d = u.robot_env.data
        self.task = task
        self.phases: List[Phase] = TASK_SCRIPTS[task]()
        self.site_id = mujoco.mj_name2id(
            self.m, mujoco.mjtObj.mjOBJ_SITE, TASK_SITE[task]
        )
        self.ee_id = mujoco.mj_name2id(
            self.m, mujoco.mjtObj.mjOBJ_SITE, "end_effector"
        )
        arm_joints = [
            mujoco.mj_name2id(
                self.m, mujoco.mjtObj.mjOBJ_JOINT, f"robot:panda0_joint{i}"
            )
            for i in range(1, 8)
        ]
        self.arm_dofs = np.array(
            [self.m.jnt_dofadr[j] for j in arm_joints], np.int64
        )
        self._phase_i = 0
        self._steps_in_phase = 0
        self._z_int = 0.0
        self._rng = np.random.default_rng(seed)
        self.noise = float(noise)

    # ------------------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._phase_i >= len(self.phases)

    def act(self) -> np.ndarray:
        mujoco = self._mujoco
        if self.done:
            return np.zeros(9, np.float32)
        ph = self.phases[self._phase_i]
        site = self.d.site_xpos[self.site_id].copy()
        if ph.hinge is not None:
            jname, sign, lead, radial = ph.hinge
            jid = mujoco.mj_name2id(
                self.m, mujoco.mjtObj.mjOBJ_JOINT, jname
            )
            dof = int(self.m.jnt_dofadr[jid])
            axis = self.d.xaxis[dof].copy()
            anchor = self.d.xanchor[dof].copy()
            r = site - anchor
            t_hat = np.cross(axis, r)
            n = float(np.linalg.norm(t_hat))
            t_hat = t_hat / n if n > 1e-9 else t_hat
            r_hat = r / max(float(np.linalg.norm(r)), 1e-9)
            goal = site + sign * lead * t_hat + radial * r_hat
            goal += np.asarray(ph.target(site), np.float64) - site
        else:
            goal = np.asarray(ph.target(site), np.float64)
        ee = self.d.site_xpos[self.ee_id].copy()
        err = goal - ee

        # phase transitions
        self._steps_in_phase += 1
        reached = (not ph.hold) and float(np.linalg.norm(err)) < ph.tol
        if reached or self._steps_in_phase >= ph.max_steps:
            self._phase_i += 1
            self._steps_in_phase = 0
            self._z_int = 0.0
            return self.act() if not self.done else np.zeros(9, np.float32)

        # desired cartesian velocity with integral z-sag compensation
        # (z error weighted up: gravity sag on long horizontal reaches is
        # the dominant servo error — observed ~5 cm below target during
        # push strokes with proportional-only control)
        v = ph.gain * err
        v[2] *= 1.8
        self._z_int = float(np.clip(self._z_int + err[2] * 0.15, -0.6, 0.6))
        v[2] += 1.5 * self._z_int
        n = float(np.linalg.norm(v))
        if n > ph.vmax:
            v *= ph.vmax / n

        # damped least squares on the 7 arm dofs
        jacp = np.zeros((3, self.m.nv))
        mujoco.mj_jacSite(self.m, self.d, jacp, None, self.ee_id)
        J = jacp[:, self.arm_dofs]  # (3, 7)
        lam2 = 0.01
        qdot = J.T @ np.linalg.solve(J @ J.T + lam2 * np.eye(3), v)

        a = np.zeros(9, np.float64)
        a[:7] = qdot
        a[7] = a[8] = ph.grip * 0.7
        if self.noise > 0:
            a[:7] += self._rng.normal(0.0, self.noise, 7)
        return np.clip(a, -1.0, 1.0).astype(np.float32)
