"""Emitter inflow — a build-side extension (the reference has none,
SURVEY.md §2.3.10; BASELINE config 4 requires it).

Design: the SimState's inactive padding slots are the emission pool.  An
EmitterState precomputes the lattice of seed positions once (host side); at
each ``maybe_emit`` call (inside jit) the emitter activates one batch of
seeds into free slots when ``step % interval == 0`` and pool capacity
remains.  Activation is a fixed-shape masked scatter: the next
``batch_size`` inactive slots (which, thanks to the cell sort pushing the
sentinel bin to the tail, are always the last slots) are claimed by index
arithmetic off ``num_active`` — no dynamic shapes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tisph.config import Emitter, SceneConfig
from tisph.geometry.sampler import cube_lattice
from tisph.models.state import MATERIAL_FLUID, SimState


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EmitterState:
    """Device-side emitter bookkeeping + the precomputed seed batch."""

    seeds_x: jax.Array      # (B, dim) lattice positions of one emission batch
    velocity: jax.Array     # (dim,)
    color: jax.Array        # (3,)
    density: jax.Array      # ()
    interval: jax.Array     # () i32
    emitted: jax.Array      # () i32 — particles emitted so far
    max_particles: jax.Array  # () i32 (0 = unlimited until pool exhausted)
    step: jax.Array         # () i32 — solver steps seen

    @property
    def batch_size(self) -> int:
        return self.seeds_x.shape[0]


def make_emitter_state(em: Emitter, scene: SceneConfig) -> EmitterState:
    seeds = cube_lattice(em.start, em.end, scene.particle_radius)
    return EmitterState(
        seeds_x=jnp.asarray(seeds),
        velocity=jnp.asarray(em.velocity[: scene.dim], jnp.float32),
        color=jnp.asarray(em.color, jnp.float32),
        density=jnp.asarray(em.density, jnp.float32),
        interval=jnp.asarray(max(em.interval, 1), jnp.int32),
        emitted=jnp.asarray(0, jnp.int32),
        max_particles=jnp.asarray(em.max_particles, jnp.int32),
        step=jnp.asarray(0, jnp.int32),
    )


# object_id stamped on every emitted particle (distinct from fluid-block /
# rigid-body ids so diagnostics can tell emitted rows apart)
EMITTER_OBJECT_ID = 10_000

# the nine per-particle fields an activation writes
EMIT_FIELDS = ("x", "v", "density", "pressure", "volume", "mass",
               "material", "color", "object_id")


def activate_seeds(fields: dict, idx, seeds, velocity, color, density,
                   volume0: float, dim: int) -> dict:
    """Scatter one seed batch into rows ``idx`` of the nine EMIT_FIELDS
    arrays (out-of-range idx rows drop — the fixed-shape skip mechanism).
    The ONE source of truth for what an emitted particle looks like: the
    single-chip tail-pool path (``maybe_emit``) and the sharded per-shard
    tail path (``ShardedWCSPHRect._maybe_emit``) both call it, so a new
    per-particle field or initial-value change lands in both layouts."""
    b = seeds.shape[0]
    vol = jnp.full((b,), volume0, jnp.float32)
    return dict(
        x=fields["x"].at[idx].set(seeds, mode="drop"),
        v=fields["v"].at[idx].set(
            jnp.broadcast_to(velocity, (b, dim)), mode="drop"),
        density=fields["density"].at[idx].set(density, mode="drop"),
        pressure=fields["pressure"].at[idx].set(0.0, mode="drop"),
        volume=fields["volume"].at[idx].set(vol, mode="drop"),
        mass=fields["mass"].at[idx].set(vol * density, mode="drop"),
        material=fields["material"].at[idx].set(MATERIAL_FLUID, mode="drop"),
        color=fields["color"].at[idx].set(
            jnp.broadcast_to(color, (b, 3)), mode="drop"),
        object_id=fields["object_id"].at[idx].set(
            jnp.asarray(EMITTER_OBJECT_ID, jnp.int32), mode="drop"),
    )


def maybe_emit(
    state: SimState, es: EmitterState, volume0: float
) -> tuple[SimState, EmitterState]:
    """Activate one seed batch into the tail pool when due.  Pure / jittable.

    The state must be cell-sorted (inactive slots at the tail) — true right
    after any solver step.  Emission is skipped when the pool is too small
    or the emitter exhausted; partially-filled batches are not emitted
    (fixed shapes).
    """
    b = es.batch_size
    cap = state.capacity
    due = (jax.lax.rem(es.step, es.interval) == 0)
    room = (state.num_active + b) <= cap
    under_quota = jnp.where(
        es.max_particles > 0, es.emitted + b <= es.max_particles, True
    )
    fire = due & room & under_quota

    start = state.num_active  # tail slots [start, start+b) are inactive
    idx = start + jnp.arange(b, dtype=jnp.int32)
    idx = jnp.where(fire, idx, cap)  # out-of-range drops the scatter

    new_fields = activate_seeds(
        {k: getattr(state, k) for k in EMIT_FIELDS}, idx,
        es.seeds_x, es.velocity, es.color, es.density, volume0, state.dim,
    )
    new = dataclasses.replace(
        state,
        num_active=jnp.where(fire, state.num_active + b, state.num_active),
        **new_fields,
    )
    es2 = dataclasses.replace(
        es,
        emitted=jnp.where(fire, es.emitted + b, es.emitted),
        step=es.step + 1,
    )
    return new, es2
