"""Dynamic rigid bodies with two-way fluid coupling (beyond the reference:
its rigid bodies are always static — SURVEY.md §2.3.9).

Scheme (Akinci-style coupling):

- a dynamic body's particles keep ``material = MATERIAL_BOUNDARY`` (the
  fluid sees the usual Akinci boundary pressure/viscosity terms, with
  boundary volumes recomputed every step since the body moves);
- the reaction forces of those terms are accumulated per boundary particle
  (ops/forces.rigid_reaction_kernel) and reduced per object into net force
  and torque;
- each body integrates as a rigid composite: v_com += dt (F/M + g),
  omega += dt I^-1 tau (inertia recomputed from the current particle
  distribution), and particle state updates in world space:
  v_p = v_com + omega x r (the coupling velocity), while positions are
  re-rigidified each step — x_p = com' + Rot(omega dt) (x - com), the
  EXACT rotation operator, so the body shape is preserved to fp rounding
  over arbitrarily long runs without carrying body-frame offsets through
  the per-step resort (tests/test_rigid_dynamics.py::test_long_run_shape
  soaks 5k steps);
- wall contact: when a body's particles penetrate the domain padding, the
  penetration is pushed back on the COM and the COM velocity component is
  reflected with the collision factor (the rigid analog of
  enforce_boundary_3D_v1, sph_basev2.py:158-189).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from tisph.config import SceneConfig, SolverParams
from tisph.models.state import SimState, MATERIAL_BOUNDARY


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RigidState:
    """Per-dynamic-object device state (K objects; K is static)."""

    object_ids: jax.Array  # (K,) i32 — object_id value of each body
    mass: jax.Array        # (K,)
    com: jax.Array         # (K, dim)
    v_com: jax.Array       # (K, dim)
    omega: jax.Array       # (K, 3) — 2D uses component [2] only

    @property
    def num_bodies(self) -> int:
        return self.object_ids.shape[0]


def make_rigid_state(state: SimState, scene: SceneConfig) -> RigidState:
    """Build from the initial state: bodies are the scene's rigidBodies with
    ``isDynamic`` true (the builder assigns them object ids 0..R-1 in
    order)."""
    dyn_ids = [k for k, rb in enumerate(scene.rigid_bodies) if rb.is_dynamic]
    if not dyn_ids:
        raise ValueError("scene has no dynamic rigid bodies")
    host_oid = np.asarray(jax.device_get(state.object_id))
    host_m = np.asarray(jax.device_get(state.mass))
    host_x = np.asarray(jax.device_get(state.x))
    host_mat = np.asarray(jax.device_get(state.material))
    coms, masses = [], []
    for k in dyn_ids:
        sel = (host_oid == k) & (host_mat == MATERIAL_BOUNDARY)
        if not sel.any():
            raise ValueError(f"dynamic body {k} has no particles")
        m = host_m[sel]
        coms.append((host_x[sel] * m[:, None]).sum(0) / m.sum())
        masses.append(m.sum())
    dim = state.dim
    k = len(dyn_ids)
    return RigidState(
        object_ids=jnp.asarray(dyn_ids, jnp.int32),
        mass=jnp.asarray(masses, jnp.float32),
        com=jnp.asarray(np.stack(coms), jnp.float32),
        v_com=jnp.zeros((k, dim), jnp.float32),
        omega=jnp.zeros((k, 3), jnp.float32),
    )


def _cross(a, b):
    """3D cross for (..., 3)."""
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def _pad3(a):
    """(..., dim) -> (..., 3) zero-padded (2D embeds in the xy plane)."""
    if a.shape[-1] == 3:
        return a
    pad = [(0, 0)] * (a.ndim - 1) + [(0, 3 - a.shape[-1])]
    return jnp.pad(a, pad)


def _rotation_matrix(phi3: jax.Array) -> jax.Array:
    """Exact rotation matrix for the rotation vector ``phi3 = omega * dt``
    (Rodrigues), series-safe at small angles:

        R = I + (sin t / t) [phi]x + ((1 - cos t) / t^2) [phi]x^2

    Applying the EXACT orthogonal map to the current COM offsets each step
    (instead of the linearized ``r += dt * omega x r``) preserves the body
    shape to fp rounding: the linearized update inflates every offset by
    ``sqrt(1 + |omega dt|^2)`` per step — the measured long-run shape
    drift (ROADMAP 'rigid' entry, VERDICT r2 #6)."""
    t2 = jnp.sum(phi3 * phi3)
    t = jnp.sqrt(t2)
    small = t < 1e-4
    # sin(t)/t and (1-cos(t))/t^2 with their series at t -> 0
    a = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(t) / jnp.where(small, 1.0, t))
    b = jnp.where(
        small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t)) / jnp.where(small, 1.0, t2)
    )
    k = jnp.array(
        [
            [0.0, -phi3[2], phi3[1]],
            [phi3[2], 0.0, -phi3[0]],
            [-phi3[1], phi3[0], 0.0],
        ],
        dtype=jnp.float32,
    )
    # HIGHEST: a default-precision f32 product may run in TF32 on a GPU
    # (~1e-3 relative — comparable to the particle radius at body scale)
    kk = jnp.matmul(k, k, precision=jax.lax.Precision.HIGHEST)
    return jnp.eye(3, dtype=jnp.float32) + a * k + b * kk


def integrate_rigid(
    state: SimState,
    rigid: RigidState,
    reactions: jax.Array,  # (N, dim) per-particle fluid->boundary forces
    params: SolverParams,
) -> tuple[SimState, RigidState]:
    """One symplectic step of every dynamic body + its particles (SimState
    wrapper over :func:`integrate_rigid_fields`)."""
    x, v, rigid2 = integrate_rigid_fields(
        state.x, state.v, state.mass, state.object_id,
        state.boundary_mask, rigid, reactions, params,
    )
    return dataclasses.replace(state, x=x, v=v), rigid2


def integrate_rigid_fields(
    x: jax.Array,
    v: jax.Array,
    mass: jax.Array,
    object_id: jax.Array,
    boundary_mask: jax.Array,
    rigid: RigidState,
    reactions: jax.Array,
    params: SolverParams,
) -> tuple[jax.Array, jax.Array, RigidState]:
    """One symplectic step of every dynamic body + its particles.  Pure and
    jittable; the python loop over bodies is static (K is small).  Field-
    level so the pack-carry coupled rollout (WCSPHRigid) can call it
    without a SimState round trip; returns (x, v, rigid) with only body
    rows of x/v changed."""
    dim = x.shape[1]
    dt = params.dt
    g = jnp.asarray(params.gravity, jnp.float32)
    lo = jnp.asarray(params.domain_start, jnp.float32) + params.padding
    hi = jnp.asarray(params.domain_end, jnp.float32) - params.padding

    new_com, new_vcom, new_omega = [], [], []

    for k in range(rigid.num_bodies):
        oid = rigid.object_ids[k]
        mask = (object_id == oid) & boundary_mask  # (N,)
        maskf = mask.astype(jnp.float32)[:, None]
        m_p = mass * maskf[:, 0]

        com = rigid.com[k]
        r = (x - com) * maskf  # (N, dim), zeroed off-body
        force = jnp.sum(reactions * maskf, axis=0) + rigid.mass[k] * g
        tau3 = jnp.sum(_cross(_pad3(r), _pad3(reactions * maskf)), axis=0)

        # inertia from the current particle distribution (about the COM)
        r3 = _pad3(r)
        r2 = jnp.sum(r3 * r3, axis=-1)
        eye = jnp.eye(3, dtype=jnp.float32)
        inertia = jnp.sum(
            m_p[:, None, None]
            * (r2[:, None, None] * eye - r3[:, :, None] * r3[:, None, :]),
            axis=0,
        ) + 1e-8 * eye
        if dim == 2:
            # planar rotation: omega_z = tau_z / I_zz
            domega = jnp.zeros(3).at[2].set(tau3[2] / inertia[2, 2])
        else:
            domega = jnp.linalg.solve(inertia, tau3)

        v_com = rigid.v_com[k] + dt * force / rigid.mass[k]
        omega = rigid.omega[k] + dt * domega

        # wall contact: push back max penetration, reflect v_com
        body_x = jnp.where(maskf > 0, x, com)  # off-body rows -> com (inert)
        pen_lo = jnp.max(jnp.maximum(lo - body_x, 0.0), axis=0)
        pen_hi = jnp.max(jnp.maximum(body_x - hi, 0.0), axis=0)
        shift = pen_lo - pen_hi
        hit = (pen_lo > 0) | (pen_hi > 0)
        # per-axis reflect+damp, matching the fluid clamp's v' = -c_f v
        v_com = jnp.where(hit, -params.collision_factor * v_com, v_com)
        new_c = com + dt * v_com + shift

        # particle update: v_p = v_com + omega x r (the coupling velocity
        # the fluid sees), positions re-rigidified about the COM — the
        # offsets are advected by the EXACT rotation operator Rot(omega dt)
        # instead of the linearized x += dt v_p (which inflates |r| by
        # sqrt(1 + |omega dt|^2) per step: measured long-run shape drift)
        om = omega[None, :]
        r_cur = _pad3(x - com)
        v_rot = _cross(jnp.broadcast_to(om, (x.shape[0], 3)), r_cur)[:, :dim]
        v_p = v_com[None, :] + v_rot
        rot = _rotation_matrix(omega * dt)
        r_rot = jnp.matmul(r_cur, rot.T, precision=jax.lax.Precision.HIGHEST)
        x_p = new_c[None, :] + r_rot[:, :dim]

        x = jnp.where(mask[:, None], x_p, x)
        v = jnp.where(mask[:, None], v_p, v)

        new_com.append(new_c)
        new_vcom.append(v_com)
        new_omega.append(omega)

    rigid2 = RigidState(
        object_ids=rigid.object_ids,
        mass=rigid.mass,
        com=jnp.stack(new_com),
        v_com=jnp.stack(new_vcom),
        omega=jnp.stack(new_omega),
    )
    return x, v, rigid2
