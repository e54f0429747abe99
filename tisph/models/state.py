"""Simulation state: an immutable pytree of fixed-shape device arrays.

Functional replacement for the reference's mutable Taichi SoA fields
(partice_systemv4.py:39-49: m, v, volume, x, density, pressure, material,
color, mass) plus their double-buffer copies (:70-78) — in JAX the "double
buffer" is simply the functional update ``state' = step(state)``.

Capacity is fixed at construction (padded); slots beyond the live particle
count carry ``material == MATERIAL_INVALID`` and are binned into a sentinel
grid cell so they never appear as neighbors.  This padding is also the
emitter pool: emitters activate inactive slots in place (a capability the
reference lacks, SURVEY.md §2.3.10).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

# Material codes — match the reference (partice_system.py:16-17).
MATERIAL_BOUNDARY = 0
MATERIAL_FLUID = 1
MATERIAL_INVALID = -1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SimState:
    """Particle SoA state.  All arrays have leading axis ``capacity``.

    Fields mirror partice_systemv4.py:39-49; ``num_active`` is a device
    scalar so emitters can grow the live set inside jit.
    """

    x: jax.Array          # (N, dim) f32 — positions
    v: jax.Array          # (N, dim) f32 — velocities
    density: jax.Array    # (N,) f32
    pressure: jax.Array   # (N,) f32
    mass: jax.Array       # (N,) f32 — per-particle mass = volume * density
    volume: jax.Array     # (N,) f32 — V0 for fluid; Akinci 1/sum(W) for boundary
    material: jax.Array   # (N,) i32 — MATERIAL_* codes
    color: jax.Array      # (N, 3) f32
    object_id: jax.Array  # (N,) i32
    num_active: jax.Array  # () i32
    # () i32 — running max of the candidate-window length the most recent
    # steps actually needed (quantisation-aware for the pallas sweep).
    # Carried through rollouts so SolverBase.run can detect window overflow
    # after EVERY dispatch instead of only at metrics checkpoints (between
    # which overflowing lanes would be silently dropped).  Reset by run()
    # after each check.  numpy default avoids device work at construction.
    occ_window: jax.Array = dataclasses.field(
        default_factory=lambda: np.zeros((), np.int32)
    )
    # () i32 — running max of the seg layout's block-slot requirement
    # (grid.seg_plan need_blocks * block_size, folded by WCSPH._seg_build);
    # compared against the static SweepConfig.pad_capacity by
    # SolverBase.run, same contract as occ_window.  Zero when the layout
    # is not 'seg'.
    occ_rowpad: jax.Array = dataclasses.field(
        default_factory=lambda: np.zeros((), np.int32)
    )
    # () i32 — sharded solver: 1 if any shard's stencil reach exceeded the
    # halo depth on some dispatch since the last reset (parallel/domain.py
    # folds a per-step pmax'd flag here; ShardedWCSPH.run regrows the halo
    # when it trips).  Always 0 single-device.
    occ_halo: jax.Array = dataclasses.field(
        default_factory=lambda: np.zeros((), np.int32)
    )
    # () i32 — sharded solver: count of rebuilds since the last reset where
    # the edge-exchange resort's seam guard tripped and the step fell back
    # to the stock distributed sort (parallel/domain.py::_exchange_resort).
    # Nonzero occasionally is fine (first rebuild after bind, emitter
    # activations); nonzero EVERY rebuild means the edge depth is too
    # shallow for the flow and the resort is paying all_gather prices.
    occ_resort: jax.Array = dataclasses.field(
        default_factory=lambda: np.zeros((), np.int32)
    )
    # () i32 — 2-D sharded solver (parallel/domain2d.py): running max of
    # per-shard ACTIVE row counts since the last reset.  Compared against
    # the static per-shard row capacity by ShardedWCSPH2D.run — nearing it
    # means the fixed rectangle cuts have drifted from the mass
    # distribution (dam-break pile-up) and a host-side rebalance (re-cut
    # quantiles + redistribute) is due BEFORE the migration cut would have
    # to drop particles.  Always 0 elsewhere.
    occ_shard: jax.Array = dataclasses.field(
        default_factory=lambda: np.zeros((), np.int32)
    )

    @property
    def capacity(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]

    @property
    def active_mask(self) -> jax.Array:
        return self.material != MATERIAL_INVALID

    @property
    def fluid_mask(self) -> jax.Array:
        return self.material == MATERIAL_FLUID

    @property
    def boundary_mask(self) -> jax.Array:
        return self.material == MATERIAL_BOUNDARY


def pad_capacity(n: int, multiple: int = 8) -> int:
    """Round capacity up to a lane-friendly multiple."""
    return int(-(-n // multiple) * multiple)


def make_state(
    positions: np.ndarray,
    velocities: np.ndarray,
    densities: np.ndarray,
    pressures: np.ndarray,
    materials: np.ndarray,
    colors: np.ndarray,
    object_ids: np.ndarray,
    volume0: float,
    capacity: int | None = None,
    extra_capacity: int = 0,
) -> SimState:
    """Assemble a SimState from host arrays, padding to ``capacity``.

    Per-particle mass = volume * density as in the reference
    (partice_systemv4.py:203-204: volume = m_V0, mass = volume * density).
    ``extra_capacity`` reserves inactive pool slots for emitters.
    """
    n = positions.shape[0]
    dim = positions.shape[1]
    if capacity is None:
        capacity = pad_capacity(n + extra_capacity)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < particle count {n}")

    def pad(arr: np.ndarray, fill: float) -> np.ndarray:
        out_shape = (capacity,) + arr.shape[1:]
        out = np.full(out_shape, fill, dtype=arr.dtype)
        out[:n] = arr
        return out

    x = pad(positions.astype(np.float32), 0.0)
    v = pad(velocities.astype(np.float32), 0.0)
    density = pad(densities.astype(np.float32), 0.0)
    pressure = pad(pressures.astype(np.float32), 0.0)
    material = pad(materials.astype(np.int32), MATERIAL_INVALID)
    color = pad(colors.astype(np.float32), 0.0)
    object_id = pad(object_ids.astype(np.int32), -1)
    volume = np.full((capacity,), volume0, dtype=np.float32)
    mass = volume * density

    return SimState(
        x=jnp.asarray(x),
        v=jnp.asarray(v),
        density=jnp.asarray(density),
        pressure=jnp.asarray(pressure),
        mass=jnp.asarray(mass),
        volume=jnp.asarray(volume),
        material=jnp.asarray(material),
        color=jnp.asarray(color),
        object_id=jnp.asarray(object_id),
        num_active=jnp.asarray(n, dtype=jnp.int32),
    )


def pad_state_capacity(state: SimState, capacity: int) -> SimState:
    """Grow the capacity with inactive slots (material = MATERIAL_INVALID)."""
    if capacity == state.capacity:
        return state
    if capacity < state.capacity:
        raise ValueError("capacity can only grow")
    pad = capacity - state.capacity

    def pad_leaf(a):
        if a.ndim == 0:
            return a
        fill = MATERIAL_INVALID if jnp.issubdtype(a.dtype, jnp.integer) else 0
        return jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1), constant_values=fill)

    return jax.tree.map(pad_leaf, state)


def state_to_host(state: SimState) -> dict[str, np.ndarray]:
    """Device -> host snapshot of the live particles.

    Counterpart of the reference ``dump()`` (partice_systemv4.py:279-296) but
    complete: includes density/pressure/mass/volume so a run can be restarted
    from a snapshot (the reference dump drops them, making restart
    impossible — SURVEY.md §5.4).
    """
    host: dict[str, Any] = jax.device_get(dataclasses.asdict(state))
    n = int(host.pop("num_active"))
    host.pop("occ_window", None)  # transient diagnostics, not state
    host.pop("occ_rowpad", None)
    host.pop("occ_halo", None)
    host.pop("occ_resort", None)
    host.pop("occ_shard", None)
    return {k: np.asarray(a[:n]) for k, a in host.items()} | {"num_active": np.asarray(n)}
