"""Scripted PushT expert for demonstration generation (the port's own copy
of the JAX package's ``envs/pusht_expert.py``, numpy only).

The reference trains on human demonstrations (pusht_cchi_v7_replay.zarr,
README.md:30-34), which are not in this repository; this expert generates
in-env demonstrations good enough to train a behavior-cloning policy whose
`test_mean_score` (env_runner/pusht_image_runner.py:247-264 protocol)
clearly beats a random policy. ``tools/gen_pusht_demos.py`` drives it; the
committed corpus ``corpora/pusht_demos_r5b.npz`` came from the JAX copy.

With the same env seed and the same ``np.random.Generator``, this expert
draws its noise in the JAX copy's order and gives the JAX copy's actions.

Strategy (rotate/translate decomposition):
* rotation error dominant -> tangential push at a lever point (bar end /
  stem tip): maximum torque per unit translation;
* translation error dominant -> push through the block's center of mass
  along the goal direction: minimum parasitic rotation.
Between pushes the agent navigates to a staging point behind the intended
contact, detouring around the block when the straight line would bump it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from unified_video_action_tpu_torch.envs.physics2d import _rot


def _wrap(a: float) -> float:
    return (a + np.pi) % (2 * np.pi) - np.pi


def _point_poly_distance(p: np.ndarray, poly: np.ndarray) -> float:
    """Distance from point to a convex polygon (0 if inside)."""
    n = len(poly)
    inside = True
    dmin = np.inf
    for i in range(n):
        a, b = poly[i], poly[(i + 1) % n]
        e = b - a
        if e[0] * (p[1] - a[1]) - e[1] * (p[0] - a[0]) < 0:
            inside = False
        t = np.clip(np.dot(p - a, e) / max(np.dot(e, e), 1e-12), 0.0, 1.0)
        dmin = min(dmin, float(np.linalg.norm(p - (a + t * e))))
    return 0.0 if inside else dmin


def _inside_any(p: np.ndarray, polys) -> bool:
    for poly in polys:
        n = len(poly)
        ok = True
        for i in range(n):
            a, b = poly[i], poly[(i + 1) % n]
            e = b - a
            if e[0] * (p[1] - a[1]) - e[1] * (p[0] - a[0]) < 0:
                ok = False
                break
        if ok:
            return True
    return False


class PushTExpert:
    """Stateful controller: call reset() per episode, act(env) per step."""

    COM_LOCAL = np.array([0.0, 45.0])  # mean of the two box centroids
    # lever points for rotation pushes (block frame): bar ends + stem tip
    LEVERS = np.array([(-60.0, 15.0), (60.0, 15.0), (0.0, 112.0)])

    def __init__(
        self,
        step_size: float = 30.0,
        noise: float = 0.0,
        rng: Optional[np.random.Generator] = None,
    ):
        self.step_size = step_size
        self.noise = noise
        self.rng = rng or np.random.default_rng(0)
        self.reset()

    def reset(self) -> None:
        self._mode: Optional[str] = None   # "rotate" | "translate"
        self._phase = "approach"
        self._lever_i: Optional[int] = None
        self._rot_sign: float = 0.0
        self._last_agent = np.array([-1e9, -1e9])
        self._stall = 0
        self._esc_rot = 0
        self._escape_steps = 0
        self._escape_dir = np.zeros(2)
        self._mpc_prev: Optional[np.ndarray] = None
        self._mpc_cooldown = 0

    # ------------------------------------------------------------------

    def act(self, env) -> np.ndarray:
        agent = np.asarray(env.agent.position, dtype=np.float64)
        pose = np.array([*env.block.position, env.block.angle])
        goal = np.asarray(env.goal_pose, dtype=np.float64)
        polys = [np.asarray(p, dtype=np.float64)
                 for p in env._block_world_polys()]

        R = _rot(float(pose[2]))
        Rg = _rot(float(goal[2]))
        com = pose[:2] + R @ self.COM_LOCAL
        com_goal = goal[:2] + Rg @ self.COM_LOCAL
        e_t_vec = com_goal - com
        e_t = float(np.linalg.norm(e_t_vec))
        e_r = _wrap(float(goal[2] - pose[2]))

        # stall detection: if the agent hasn't moved for a while the current
        # plan is wedged (staging point in a wall, ring waypoint clipped to
        # a fixed point) — sidestep toward the arena center and replan
        if np.linalg.norm(agent - self._last_agent) < 2.0:
            self._stall += 1
        else:
            self._stall = 0
        self._last_agent = agent.copy()
        if self._escape_steps > 0:
            self._escape_steps -= 1
            return self._clip(agent + self._escape_dir * 30.0)
        if self._stall >= 8:
            self._stall = 0
            self._phase = "approach"
            self._lever_i = None
            self._mode = None
            # rotate the escape direction on consecutive stalls so repeated
            # wedges (block in a corner) eventually find an open route; the
            # escape persists for several steps so the replan starts from a
            # genuinely different position
            self._esc_rot += 1
            ang = (self._esc_rot % 4) * (np.pi / 2.0)
            d0 = np.array([256.0, 256.0]) - agent
            d0 = d0 / max(np.linalg.norm(d0), 1e-9)
            ca, sa = np.cos(ang), np.sin(ang)
            self._escape_dir = np.array(
                [ca * d0[0] - sa * d0[1], sa * d0[0] + ca * d0[1]]
            )
            self._escape_steps = 4
            return self._clip(agent + self._escape_dir * 30.0)

        # endgame: close to the goal the contact dynamics are too delicate
        # for the staging heuristic — switch to sampling MPC on the exact
        # simulator (score = coverage after a short rollout), which drives
        # coverage over the 0.95 success threshold directly
        if (
            e_t < 45.0
            and abs(e_r) < 0.55
            and np.linalg.norm(agent - com) < 160.0
            and self._mpc_cooldown == 0
        ):
            a_mpc = self._mpc_action(env, agent)
            if a_mpc is not None:
                self._mode = "mpc"
                self._phase = "approach"
                return a_mpc
            # MPC sees no improving push from here: let the staging
            # heuristic reposition for a few steps before asking again
            self._mpc_cooldown = 5
        if self._mpc_cooldown > 0:
            self._mpc_cooldown -= 1

        # wall recovery: a block jammed against a wall can't be staged from
        # outside — push it back toward the arena center first. If the
        # straight-in staging point is itself squeezed against the wall,
        # fall back to rotated push directions.
        near_wall = (
            np.any(com < 75.0) or np.any(com > 437.0)
        ) and e_t > 30.0
        if near_wall:
            center = np.array([256.0, 256.0])
            d0 = center - com
            d0 = d0 / max(np.linalg.norm(d0), 1e-9)
            pick = None
            for ang in (0.0, 0.5, -0.5, 1.0, -1.0):
                ca, sa = np.cos(ang), np.sin(ang)
                d = np.array([ca * d0[0] - sa * d0[1],
                              sa * d0[0] + ca * d0[1]])
                contact, stage = self._contact_through(com, d, polys, False)
                if np.all(stage > 24.0) and np.all(stage < 488.0):
                    pick = (contact, stage, d)
                    break
            if pick is None:
                contact, stage = self._contact_through(com, d0, polys, False)
                pick = (contact, stage, d0)
            contact, stage, d = pick
            if self._mode != "recover":
                self._phase = "approach"
            self._mode = "recover"
            return self._approach_push(
                agent, stage, contact, d, pose, polys, False, tol=30.0
            )

        # mode choice with hysteresis: compare translational displacement to
        # the rotational displacement at a ~80 px lever arm. Success needs
        # coverage > 0.95 ≈ pose error < ~3 px / 0.04 rad, so the exit
        # thresholds are tight and push advances scale with the error.
        rot_disp = abs(e_r) * 80.0
        mode = self._mode if self._mode in ("rotate", "translate") else None
        if mode is None:
            mode = "rotate" if rot_disp > e_t else "translate"
        elif mode == "rotate" and (abs(e_r) < 0.03 or rot_disp < 0.4 * e_t):
            mode = "translate"
        elif mode == "translate" and (
            (e_t < 3.0 and abs(e_r) > 0.04) or rot_disp > 2.5 * e_t
        ):
            mode = "rotate"
        if mode != self._mode:
            self._phase = "approach"
            self._lever_i = None
        self._mode = mode

        fine = e_t < 14.0 and abs(e_r) < 0.25

        if mode == "translate":
            d = e_t_vec / max(e_t, 1e-9)
            contact, stage = self._contact_through(com, d, polys, fine)
            advance = float(np.clip(e_t * 0.5, 2.0, 13.0))
            return self._approach_push(
                agent, stage, contact, d, pose, polys, fine,
                tol=(20.0 if fine else 24.0), advance=advance,
            )

        # rotation sign: near ±pi the wrap makes sign(e_r) unstable — latch
        # the direction and only re-decide once clearly away from the cut
        if abs(e_r) < 2.7 or self._rot_sign == 0.0:
            self._rot_sign = 1.0 if e_r > 0 else -1.0
        s = self._rot_sign

        # rotate: every push-through also TRANSLATES the block along the
        # push direction, so prefer the lever whose tangential push points
        # toward the translation goal — the rotation then corrects both
        # errors instead of drifting the block into a wall. Keep the current
        # lever while pushing; skip staging points outside the arena.
        levers_w = pose[:2] + self.LEVERS @ R.T
        e_t_dir = e_t_vec / max(e_t, 1e-9)
        best = None
        for i, lever in enumerate(levers_w):
            radial = lever - com
            rn = np.linalg.norm(radial)
            if rn < 1e-6:
                continue
            dpush = s * np.array([-radial[1], radial[0]]) / rn
            stage = lever - dpush * (19.0 if fine else 27.0)
            reach = float(np.linalg.norm(stage - agent))
            in_bounds = np.all(stage > 28.0) and np.all(stage < 484.0)
            score = 0.5 * reach + (0.0 if in_bounds else 1e4)
            score -= 60.0 * float(np.dot(dpush, e_t_dir))  # drift alignment
            if self._lever_i == i:
                score -= 40.0  # hysteresis: keep the current lever
            if best is None or score < best[0]:
                best = (score, i, lever, dpush, stage)
        _, i, lever, dpush, stage = best
        self._lever_i = i
        # rotation speed proportional to the remaining error: the lever arm
        # is ~70-90 px, so a full-speed 30 px/step chase rotates ~0.4 rad per
        # control step and overshoots badly near the target
        advance = float(np.clip(abs(e_r) * 24.0, 2.0, 10.0))
        return self._approach_push(
            agent, stage, lever, dpush, pose, polys,
            fine or abs(e_r) < 0.6, tol=36.0, advance=advance,
        )

    # ------------------------------------------------------------------

    def _mpc_action(self, env, agent) -> Optional[np.ndarray]:
        """One step of sampling MPC on the true simulator: try small agent
        displacement candidates, roll each out H control steps (holding the
        displacement direction), score by final coverage with a pose-error
        tiebreak, return the best first action. Returns None if no candidate
        beats staying put by a margin (caller falls back to the heuristic to
        reposition)."""
        H = 3
        goal = np.asarray(env.goal_pose, dtype=np.float64)
        Rg = _rot(float(goal[2]))
        com_goal = goal[:2] + Rg @ self.COM_LOCAL
        snap = env.get_phys_state()

        def rollout(c):
            env.set_phys_state(snap)
            first = None
            for _ in range(H):
                a = self._clip(np.asarray(env.agent.position) + c)
                if first is None:
                    first = a
                env.step_dynamics(a)
            cov = env._coverage()
            pose = np.array([*env.block.position, env.block.angle])
            Rp = _rot(float(pose[2]))
            com_p = pose[:2] + Rp @ self.COM_LOCAL
            et = float(np.linalg.norm(com_goal - com_p))
            er = abs(_wrap(float(goal[2] - pose[2])))
            return cov * 100.0 - 0.2 * et - 16.0 * er, first

        stay_score, _ = rollout(np.zeros(2))
        # momentum: when the previous direction still beats staying put by a
        # margin, keep it without sweeping — cuts the per-step rollout count
        # from 17 to 2 during straight pushes
        if self._mpc_prev is not None:
            s_prev, first_prev = rollout(self._mpc_prev)
            if s_prev > stay_score + 0.35:
                env.set_phys_state(snap)
                return first_prev
        dirs = [
            np.array([np.cos(a), np.sin(a)])
            for a in np.linspace(0.0, 2 * np.pi, 8, endpoint=False)
        ]
        best_score, best_first, best_c = stay_score, None, None
        for c in (d * m for d in dirs for m in (7.0, 16.0)):
            s, first = rollout(c)
            if s > best_score:
                best_score, best_first, best_c = s, first, c
        env.set_phys_state(snap)
        self._mpc_prev = best_c
        if best_first is None:  # staying put is optimal: let the heuristic
            return None          # reposition the agent instead
        return best_first

    def _contact_through(self, com, d, polys, fine):
        """Ray-march from the COM along -d to the block surface; the contact
        point is just outside it, the staging point a bit further back."""
        t_surf = 0.0
        for t in np.arange(0.0, 140.0, 2.0):
            if _inside_any(com - d * t, polys):
                t_surf = t
        contact = com - d * (t_surf + 17.0)
        stage = com - d * (t_surf + (24.0 if fine else 32.0))
        return contact, stage

    def _approach_push(
        self, agent, stage, through, dpush, pose, polys, fine, tol=24.0,
        advance=None,
    ):
        """Shared approach->push state machine: get behind ``through`` at
        ``stage``, then drive along ``dpush`` through it. ``through`` and
        ``dpush`` are recomputed by the caller every step, so a rotation
        push follows the moving lever (continuous arc pushing)."""
        if self._phase == "approach":
            if np.linalg.norm(agent - stage) < 9.0:
                self._phase = "push"
            else:
                target = self._navigate(agent, stage, pose, polys)
                return self._command(agent, target, fine)
        rel = agent - through
        along = float(np.dot(rel, dpush))
        off_line = float(np.linalg.norm(rel - along * dpush))
        if off_line > tol or along > 10.0:
            self._phase = "approach"
            target = self._navigate(agent, stage, pose, polys)
            return self._command(agent, target, fine)
        if advance is None:
            advance = 8.0 if fine else 13.0
        return self._command(agent, through + dpush * advance, fine)

    def _path_blocked(
        self, a: np.ndarray, b: np.ndarray, polys, clearance: float = 20.0
    ) -> bool:
        """True if the straight segment a->b passes within ``clearance`` of
        the T block. The last ~45 px are exempt: staging points sit right
        next to the block by design."""
        L = np.linalg.norm(b - a)
        check_L = L - min(45.0, L)
        if check_L > 0:
            n = max(int(check_L / 10.0), 2)
            for t in np.linspace(0.0, check_L / L, n):
                p = a + (b - a) * t
                for poly in polys:
                    if _point_poly_distance(p, poly) < clearance:
                        return True
        # tail: mild proximity is fine (staging points sit ~19-27 px from
        # the block) but anything closer than the agent radius would SHOVE
        # the block while "approaching" — the single most destructive
        # failure mode (it wrecks already-converged states)
        n_tail = 8
        for t in np.linspace(max(check_L, 0.0) / max(L, 1e-9), 1.0, n_tail):
            p = a + (b - a) * t
            for poly in polys:
                if _point_poly_distance(p, poly) < 16.0:
                    return True
        return False

    def _navigate(self, agent, target, pose, polys) -> np.ndarray:
        """Next waypoint toward ``target``: straight if clear, otherwise step
        angularly around a detour ring centered on the block."""
        if not self._path_blocked(agent, target, polys):
            return target
        center = np.asarray(pose[:2])
        ring = 150.0
        v_a = agent - center
        r_a = float(np.linalg.norm(v_a))
        if r_a < 1e-6:
            v_a, r_a = np.array([1.0, 0.0]), 1.0
        phi_a = np.arctan2(v_a[1], v_a[0])
        v_t = target - center
        phi_t = np.arctan2(v_t[1], v_t[0])
        dphi = _wrap(phi_t - phi_a)
        if abs(dphi) < 0.12:
            # angularly aligned: head straight in (breaks the ring fixed
            # point; the clearance exemption covers the final stretch)
            return target
        r_next = min(max(r_a, ring), ring + 40.0)
        step_phi = np.sign(dphi) * min(abs(dphi), self.step_size / r_next)
        phi = phi_a + step_phi
        wp = center + r_next * np.array([np.cos(phi), np.sin(phi)])
        # walls: slide the ring waypoint back into the arena; angular
        # progress still accumulates over steps
        return np.clip(wp, 30.0, 482.0)

    def _command(self, agent, target, fine=False) -> np.ndarray:
        step = np.asarray(target, dtype=np.float64) - agent
        L = np.linalg.norm(step)
        lim = self.step_size * (0.6 if fine else 1.0)
        if L > lim:
            step = step / L * lim
        out = agent + step
        if self.noise > 0:
            out = out + self.rng.normal(0.0, self.noise, 2)
        return self._clip(out)

    @staticmethod
    def _clip(p: np.ndarray) -> np.ndarray:
        return np.clip(p, 12.0, 500.0)


def rollout_expert(
    env, expert: Optional[PushTExpert] = None, max_steps: int = 300,
    render: bool = True,
):
    """Run the expert in ``env`` (already reset); returns a dict of stacked
    imgs/states/actions plus the episode's max coverage reward."""
    expert = expert or PushTExpert()
    expert.reset()
    imgs, states, actions = [], [], []
    max_reward = 0.0
    done = False
    for _ in range(max_steps):
        agent = np.asarray(env.agent.position)
        block = np.asarray(env.block.position)
        states.append(
            np.concatenate([agent, block, [env.block.angle % (2 * np.pi)]])
        )
        if render:
            imgs.append(env.render("rgb_array"))
        action = expert.act(env)
        actions.append(action.astype(np.float32))
        _, reward, done, _, _ = env.step(action)
        max_reward = max(max_reward, float(reward))
        if done:
            break
    return {
        "img": np.asarray(imgs, dtype=np.uint8),
        "state": np.asarray(states, dtype=np.float32),
        "action": np.asarray(actions, dtype=np.float32),
        "max_reward": max_reward,
        "success": bool(done),
    }
