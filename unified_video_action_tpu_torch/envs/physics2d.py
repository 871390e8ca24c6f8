"""Minimal 2D rigid-body physics for the PushT environment (the port's copy
of the JAX package's ``envs/physics2d.py``, numpy only; ``cross2`` computes
``np.cross`` of 2-vectors as it does, without its per-call cost).

The reference relies on pymunk (env/pusht/pusht_env.py); pymunk is not part of
this framework's dependency set, and PushT needs only a tiny slice of a physics
engine, so this is a from-scratch impulse-based solver specialised to the
PushT regime:

* zero gravity, ``space.damping = 0`` — dynamic bodies lose all inherited
  velocity each step (v *= damping**dt with damping=0), so block motion is
  quasi-static: contact impulses from the kinematic agent circle and the walls
  are the only motion source, exactly like the reference configuration
  (pusht_env.py:509-511 setup: gravity 0, damping 0).
* bodies: one dynamic body (the T block, two convex polygons), one kinematic
  circle (the agent; infinite mass, PD-velocity-driven), four static wall
  segments with radius 2.
* sequential-impulse contact solver with Coulomb friction (multiplicative
  friction combine like pymunk: agent·block = 1, block·wall = 0), Baumgarte
  positional bias, pymunk-default collision slop 0.1, 10 iterations.
* rotation happens about the center of gravity; ``Body.position`` is the body
  origin (pymunk convention), with the COG offset handled in the kinematics.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _rot(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]])


def cross2(u: np.ndarray, v: np.ndarray) -> float:
    """z of the cross product of two 2-vectors: ``np.cross``'s arithmetic
    (``u0 v1 - u1 v0``) without its per-call cost."""
    return u[0] * v[1] - u[1] * v[0]


def _cross_scalar(w: float, v: np.ndarray) -> np.ndarray:
    """2D cross product of scalar angular velocity with vector: w × v."""
    return np.array([-w * v[1], w * v[0]])


@dataclasses.dataclass
class Body:
    """Rigid body. ``position`` is the body-frame origin (pymunk convention);
    rotation is about the center of gravity ``cog_local`` (body frame)."""

    position: np.ndarray
    angle: float = 0.0
    velocity: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    angular_velocity: float = 0.0
    mass: float = 1.0
    moment: float = 1.0
    cog_local: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    kinematic: bool = False
    static: bool = False

    @property
    def inv_mass(self) -> float:
        return 0.0 if (self.kinematic or self.static) else 1.0 / self.mass

    @property
    def inv_moment(self) -> float:
        return 0.0 if (self.kinematic or self.static) else 1.0 / self.moment

    @property
    def cog_world(self) -> np.ndarray:
        return self.position + _rot(self.angle) @ self.cog_local

    def local_to_world(self, p: np.ndarray) -> np.ndarray:
        return self.position + _rot(self.angle) @ np.asarray(p, dtype=np.float64)

    def velocity_at(self, p_world: np.ndarray) -> np.ndarray:
        return self.velocity + _cross_scalar(
            self.angular_velocity, p_world - self.cog_world
        )

    def apply_impulse(self, j: np.ndarray, p_world: np.ndarray) -> None:
        if self.kinematic or self.static:
            return
        self.velocity = self.velocity + j * self.inv_mass
        r = p_world - self.cog_world
        self.angular_velocity += (r[0] * j[1] - r[1] * j[0]) * self.inv_moment

    def integrate(self, dt: float) -> None:
        if self.static:
            return
        if self.kinematic:
            self.position = self.position + self.velocity * dt
            self.angle += self.angular_velocity * dt
            return
        # dynamic: COM translates; origin follows the rotation about COM
        com = self.cog_world
        com_new = com + self.velocity * dt
        angle_new = self.angle + self.angular_velocity * dt
        self.angle = angle_new
        self.position = com_new - _rot(angle_new) @ self.cog_local


@dataclasses.dataclass
class CircleShape:
    body: Body
    radius: float
    friction: float = 1.0


@dataclasses.dataclass
class PolyShape:
    body: Body
    vertices: np.ndarray  # (N, 2) body-frame, CCW or CW
    friction: float = 1.0

    def world_vertices(self) -> np.ndarray:
        R = _rot(self.body.angle)
        return self.body.position + self.vertices @ R.T


@dataclasses.dataclass
class SegmentShape:
    a: np.ndarray
    b: np.ndarray
    radius: float
    friction: float = 0.0  # pymunk default; reference walls never set friction


@dataclasses.dataclass
class Contact:
    body_a: Body            # dynamic body receiving +normal impulse
    body_b: Optional[Body]  # other body (None = static wall)
    point: np.ndarray
    normal: np.ndarray      # from b to a
    penetration: float
    friction: float
    jn_acc: float = 0.0
    jt_acc: float = 0.0


def moment_for_poly(mass: float, vertices: Sequence[Tuple[float, float]]) -> float:
    """Polygon moment of inertia about the body origin (pymunk formula)."""
    verts = np.asarray(vertices, dtype=np.float64)
    n = len(verts)
    num = 0.0
    den = 0.0
    for i in range(n):
        v1 = verts[i]
        v2 = verts[(i + 1) % n]
        a = abs(float(cross2(v2, v1)))
        b = float(v1 @ v1 + v1 @ v2 + v2 @ v2)
        num += a * b
        den += a
    return (mass * num) / (6.0 * den)


def poly_centroid(vertices: np.ndarray) -> np.ndarray:
    v = np.asarray(vertices, dtype=np.float64)
    x = v[:, 0]
    y = v[:, 1]
    xn = np.roll(x, -1)
    yn = np.roll(y, -1)
    cross = x * yn - xn * y
    area = cross.sum() / 2.0
    cx = ((x + xn) * cross).sum() / (6 * area)
    cy = ((y + yn) * cross).sum() / (6 * area)
    return np.array([cx, cy])


def _closest_point_on_segment(p, a, b):
    ab = b - a
    t = np.clip(np.dot(p - a, ab) / max(np.dot(ab, ab), 1e-12), 0.0, 1.0)
    return a + t * ab


def _point_in_poly(p: np.ndarray, verts: np.ndarray) -> bool:
    sign = 0
    n = len(verts)
    for i in range(n):
        a, b = verts[i], verts[(i + 1) % n]
        c = cross2(b - a, p - a)
        s = 1 if c > 0 else (-1 if c < 0 else 0)
        if s != 0:
            if sign == 0:
                sign = s
            elif s != sign:
                return False
    return True


def collide_circle_poly(
    circle: CircleShape, poly: PolyShape, verts: Optional[np.ndarray] = None
) -> List[Contact]:
    if verts is None:
        verts = poly.world_vertices()
    c = circle.body.position
    if _point_in_poly(c, verts):
        # center inside: push out along least-penetration edge normal
        best_d, best_n, best_p = -np.inf, None, None
        n_v = len(verts)
        for i in range(n_v):
            a, b = verts[i], verts[(i + 1) % n_v]
            edge = b - a
            n = np.array([edge[1], -edge[0]])
            n = n / (np.linalg.norm(n) + 1e-12)
            # ensure outward: positive side away from centroid
            if np.dot(n, poly_centroid(verts) - a) > 0:
                n = -n
            d = np.dot(c - a, n)  # negative inside
            if d > best_d:
                best_d, best_n, best_p = d, n, c - n * d
        pen = circle.radius - best_d
        return [
            Contact(
                body_a=circle.body,
                body_b=poly.body,
                point=best_p,
                normal=best_n,
                penetration=pen,
                friction=circle.friction * poly.friction,
            )
        ]
    # center outside: closest point on boundary
    best = None
    best_d2 = np.inf
    n_v = len(verts)
    for i in range(n_v):
        q = _closest_point_on_segment(c, verts[i], verts[(i + 1) % n_v])
        d2 = float(np.dot(c - q, c - q))
        if d2 < best_d2:
            best_d2, best = d2, q
    d = np.sqrt(best_d2)
    if d >= circle.radius:
        return []
    n = (c - best) / (d + 1e-12)
    return [
        Contact(
            body_a=circle.body,
            body_b=poly.body,
            point=best,
            normal=n,
            penetration=circle.radius - d,
            friction=circle.friction * poly.friction,
        )
    ]


def collide_poly_segment(
    poly: PolyShape,
    seg: SegmentShape,
    verts: Optional[np.ndarray] = None,
    com: Optional[np.ndarray] = None,
) -> List[Contact]:
    if verts is None:
        verts = poly.world_vertices()
    if com is None:
        com = poly.body.cog_world
    contacts = []
    # scalar math throughout: this is the hottest function in the simulator
    # (8 calls/substep); numpy small-array overhead triples the step cost
    ax, ay = float(seg.a[0]), float(seg.a[1])
    bx, by = float(seg.b[0]), float(seg.b[1])
    abx, aby = bx - ax, by - ay
    ab2 = max(abx * abx + aby * aby, 1e-12)
    comx, comy = float(com[0]), float(com[1])
    radius = seg.radius
    fr = poly.friction * seg.friction
    for v in verts:
        vx, vy = float(v[0]), float(v[1])
        t = ((vx - ax) * abx + (vy - ay) * aby) / ab2
        t = 0.0 if t < 0.0 else (1.0 if t > 1.0 else t)
        qx, qy = ax + t * abx, ay + t * aby
        dx, dy = vx - qx, vy - qy
        d = (dx * dx + dy * dy) ** 0.5
        # Side-aware contact: the contact normal points toward the side the
        # body's COM is on, and a vertex that crossed the segment line still
        # registers (signed penetration). Without this a fast push tunnels
        # the block through the arena walls — pymunk (the reference engine,
        # env/pusht/pusht_env.py:380-390) resolves these crossed contacts.
        sx, sy = comx - qx, comy - qy
        sn = (sx * sx + sy * sy) ** 0.5
        if sn > 1e-9:
            nx, ny = sx / sn, sy / sn
            signed = dx * nx + dy * ny
            if signed < radius and sn > radius:
                contacts.append(
                    Contact(
                        body_a=poly.body,
                        body_b=None,
                        point=np.array([vx, vy]),
                        normal=np.array([nx, ny]),
                        penetration=radius - signed,
                        friction=fr,
                    )
                )
                continue
        if d < radius:
            inv = 1.0 / (d + 1e-12)
            contacts.append(
                Contact(
                    body_a=poly.body,
                    body_b=None,
                    point=np.array([vx, vy]),
                    normal=np.array([dx * inv, dy * inv]),
                    penetration=radius - d,
                    friction=fr,
                )
            )
    # keep the two deepest contacts (manifold cap, as physics engines do)
    contacts.sort(key=lambda c: -c.penetration)
    return contacts[:2]


def collide_circle_segment(circle: CircleShape, seg: SegmentShape) -> List[Contact]:
    c = circle.body.position
    q = _closest_point_on_segment(c, seg.a, seg.b)
    delta = c - q
    d = float(np.linalg.norm(delta))
    rsum = circle.radius + seg.radius
    if d >= rsum:
        return []
    n = delta / (d + 1e-12)
    return [
        Contact(
            body_a=circle.body,
            body_b=None,
            point=c - n * circle.radius,
            normal=n,
            penetration=rsum - d,
            friction=circle.friction * seg.friction,
        )
    ]


class Space:
    """PushT-specialised physics space (gravity-free)."""

    def __init__(self, damping: float = 0.0, iterations: int = 10,
                 collision_slop: float = 0.1, baumgarte: float = 0.2):
        self.damping = damping
        self.iterations = iterations
        self.collision_slop = collision_slop
        self.baumgarte = baumgarte
        self.bodies: List[Body] = []
        self.circles: List[CircleShape] = []
        self.polys: List[PolyShape] = []
        self.segments: List[SegmentShape] = []
        self.n_contact_points = 0

    def step(self, dt: float) -> None:
        # damping on dynamic bodies (pymunk: v *= damping**dt; damping=0 -> 0)
        factor = self.damping ** dt if self.damping > 0 else 0.0
        for b in self.bodies:
            if not (b.kinematic or b.static):
                b.velocity = b.velocity * factor
                b.angular_velocity *= factor

        # contacts (world vertices / COG computed once per poly per substep)
        contacts: List[Contact] = []
        poly_geo = [
            (poly, poly.world_vertices(), poly.body.cog_world)
            for poly in self.polys
        ]
        for circ in self.circles:
            for poly, verts, _com in poly_geo:
                contacts += collide_circle_poly(circ, poly, verts)
            if not circ.body.kinematic:
                for seg in self.segments:
                    contacts += collide_circle_segment(circ, seg)
        for poly, verts, com in poly_geo:
            # bbox prefilter: a vertex can only contact a segment when it is
            # within seg.radius of it (or crossed it) — exact rejection
            vx_min, vy_min = verts.min(axis=0)
            vx_max, vy_max = verts.max(axis=0)
            for seg in self.segments:
                r = seg.radius
                sx0, sx1 = (seg.a[0], seg.b[0]) if seg.a[0] <= seg.b[0] else (seg.b[0], seg.a[0])
                sy0, sy1 = (seg.a[1], seg.b[1]) if seg.a[1] <= seg.b[1] else (seg.b[1], seg.a[1])
                if (
                    vx_max < sx0 - r or vx_min > sx1 + r
                    or vy_max < sy0 - r or vy_min > sy1 + r
                ):
                    continue
                contacts += collide_poly_segment(poly, seg, verts, com)
        self.n_contact_points += len(contacts)

        # sequential impulse solver with Baumgarte bias. Per-contact
        # quantities that do not change across iterations (lever arms,
        # effective masses, bias) are precomputed; the iteration loop is
        # pure scalar float math (identical IEEE ops to the numpy version,
        # ~5x faster at these tiny sizes).
        slop = self.collision_slop
        bg_dt = self.baumgarte / dt
        solve = []
        for c in contacts:
            a, b = c.body_a, c.body_b
            nx, ny = float(c.normal[0]), float(c.normal[1])
            px, py = float(c.point[0]), float(c.point[1])
            acog = a.cog_world
            rax, ray = px - float(acog[0]), py - float(acog[1])
            cross_an = rax * ny - ray * nx
            kn = a.inv_mass + cross_an * cross_an * a.inv_moment
            cross_at = rax * nx + ray * ny  # cross(ra, t), t = (-ny, nx)
            kt = a.inv_mass + cross_at * cross_at * a.inv_moment
            rbx = rby = 0.0
            if b is not None:
                bcog = b.cog_world
                rbx, rby = px - float(bcog[0]), py - float(bcog[1])
                cross_bn = rbx * ny - rby * nx
                kn += b.inv_mass + cross_bn * cross_bn * b.inv_moment
                cross_bt = rbx * nx + rby * ny
                kt += b.inv_mass + cross_bt * cross_bt * b.inv_moment
            bias = bg_dt * max(0.0, c.penetration - slop)
            solve.append((c, a, b, nx, ny, rax, ray, rbx, rby, kn, kt, bias))

        for _ in range(self.iterations):
            for c, a, b, nx, ny, rax, ray, rbx, rby, kn, kt, bias in solve:
                av, bw = a.velocity, a.angular_velocity
                vx = float(av[0]) - bw * ray
                vy = float(av[1]) + bw * rax
                if b is not None:
                    bv, bbw = b.velocity, b.angular_velocity
                    vx -= float(bv[0]) - bbw * rby
                    vy -= float(bv[1]) + bbw * rbx
                vn = vx * nx + vy * ny
                if kn > 0:
                    jn = -(vn - bias) / kn
                    jn_new = max(c.jn_acc + jn, 0.0)
                    jn = jn_new - c.jn_acc
                    c.jn_acc = jn_new
                    if not (a.kinematic or a.static):
                        im = a.inv_mass
                        a.velocity[0] += jn * nx * im
                        a.velocity[1] += jn * ny * im
                        a.angular_velocity += (
                            (rax * jn * ny - ray * jn * nx) * a.inv_moment
                        )
                    if b is not None and not (b.kinematic or b.static):
                        im = b.inv_mass
                        b.velocity[0] -= jn * nx * im
                        b.velocity[1] -= jn * ny * im
                        b.angular_velocity -= (
                            (rbx * jn * ny - rby * jn * nx) * b.inv_moment
                        )

                if c.friction > 0.0 and kt > 0:
                    tx, ty = -ny, nx
                    av, bw = a.velocity, a.angular_velocity
                    vx = float(av[0]) - bw * ray
                    vy = float(av[1]) + bw * rax
                    if b is not None:
                        bv, bbw = b.velocity, b.angular_velocity
                        vx -= float(bv[0]) - bbw * rby
                        vy -= float(bv[1]) + bbw * rbx
                    vt = vx * tx + vy * ty
                    jt = -vt / kt
                    max_f = c.friction * c.jn_acc
                    jt_new = c.jt_acc + jt
                    if jt_new < -max_f:
                        jt_new = -max_f
                    elif jt_new > max_f:
                        jt_new = max_f
                    jt = jt_new - c.jt_acc
                    c.jt_acc = jt_new
                    if not (a.kinematic or a.static):
                        im = a.inv_mass
                        a.velocity[0] += jt * tx * im
                        a.velocity[1] += jt * ty * im
                        a.angular_velocity += (
                            (rax * jt * ty - ray * jt * tx) * a.inv_moment
                        )
                    if b is not None and not (b.kinematic or b.static):
                        im = b.inv_mass
                        b.velocity[0] -= jt * tx * im
                        b.velocity[1] -= jt * ty * im
                        b.angular_velocity -= (
                            (rbx * jt * ty - rby * jt * tx) * b.inv_moment
                        )

        for b in self.bodies:
            b.integrate(dt)
