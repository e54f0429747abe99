"""WCSPHRigid — WCSPH with dynamic rigid bodies (two-way coupling).

Extends the flagship step with a reaction-force sweep and a rigid-body
integrator (models/rigid.py).  The step state is the pair
``(SimState, RigidState)``; boundary volumes are recomputed every step
(the bodies move), matching the reference's per-step recompute
(sph_basev2.py:212) which only this solver actually needs.

On the pallas sweeps (the GPU default) the boundary volume, density and
the fused force + fluid->boundary reaction run as row-confined seg kernels
(_coupled_step_seg); other configurations use the jnp blocked path.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tisph.config import SceneConfig
from tisph.models.rigid import RigidState, integrate_rigid, make_rigid_state
from tisph.models.solver_base import SolverBase
from tisph.models.state import SimState
from tisph.models.wcsph import WCSPH
from tisph.ops import forces as F
from tisph.ops import grid as gridops
from tisph.ops.neighbors import SweepConfig


class WCSPHRigid(WCSPH):
    def __init__(self, scene: SceneConfig, **kw):
        kw.setdefault("boundary_mode", "per_step")
        super().__init__(scene, **kw)
        if self.boundary_mode != "per_step":
            raise ValueError("dynamic rigid bodies need boundary_mode='per_step'")

    # -- carry = (SimState, RigidState) -----------------------------------
    def init_rigid(self, state: SimState) -> RigidState:
        return make_rigid_state(state, self.scene)

    def _coupled_step_fn(self, carry):
        if self.sweep_cfg is not None and self.sweep_cfg.impl == "pallas":
            return self._coupled_step_seg(carry)
        state, rigid = carry
        spec, params, scfg = self.spec, self.params, self.sweep_cfg

        state, sorted_ids, _ = gridops.sort_state_by_cell(state, spec)
        nd = gridops.build_neighbor_data(state, sorted_ids, spec, scfg)
        state = self._track_occ(state, nd.window_need)

        volume = F.compute_boundary_volumes(state, nd, spec, params, scfg)
        state = dataclasses.replace(state, volume=volume)

        density = F.compute_densities(state, nd, spec, params, scfg)
        rho, pressure = F.compute_pressures(density, params)
        state = dataclasses.replace(state, density=rho, pressure=pressure)

        d_velocity = F.compute_forces(state, nd, spec, params, scfg)
        reactions = F.compute_rigid_reactions(state, nd, spec, params, scfg)

        state = F.advect(state, d_velocity, params)
        state, rigid = integrate_rigid(state, rigid, reactions, params)
        state = F.enforce_domain_boundary(state, params)
        return state, rigid

    def _coupled_step_seg(self, carry):
        state, rigid = carry
        state, cache = self._seg_build(state)
        return self._coupled_apply((state, rigid), cache)

    def _coupled_apply(self, carry, cache):
        """One coupled physics step against a (possibly stale) seg
        structure, on the pallas seg path: three sweeps per substep —
        boundary volume, density, and the FUSED force+reaction pass (one
        kernel emits the fluid dv on fluid rows and the fluid->boundary
        reaction on boundary rows; round 4, was four sweeps) — all
        running in pack space (WCSPH._seg_apply_pack); only the rigid
        integration (O(bodies)) stays in plain jnp.  Matches
        _coupled_step_fn's blocked physics (gated by
        tests/test_rigid_dynamics.py::test_seg_coupled_matches_blocked).

        Under ``resort_every`` amortization (rollout_coupled) the staleness
        argument of WCSPH._seg_apply extends unchanged to the moving
        boundary particles: the id test uses cached sort-time ids on both
        sides, rigid-body motion is CFL-bounded like the fluid's, and the
        boundary-volume sweep still runs per substep on CURRENT positions
        (the bodies move, sph_basev2.py:212)."""
        from tisph.ops.pallas import sweeps as ps

        state, rigid = carry
        pack = ps.pack_state(
            state.x, state.v, state.density, state.pressure,
            state.mass, state.volume, state.material, cache[2], self.params,
        )
        pack, rigid = self._coupled_apply_pack(
            pack, rigid, state.object_id, cache
        )
        return self._seg_unpack(state, pack), rigid

    def _coupled_apply_pack(self, pack, rigid, object_id, cache):
        """Pack-space coupled substep: the fluid physics + fused reaction
        output come from WCSPH._seg_apply_pack(with_reactions=True); the
        body integration reads x/v/mass off the pack rows and writes the
        rotated body particles back.  ``object_id`` is in the cache's
        sorted order (constant within an R-group)."""
        import jax.numpy as jnp

        from tisph.models.rigid import integrate_rigid_fields
        from tisph.ops.pallas import sweeps as ps

        dim = self.spec.dim
        pack, reactions = self._seg_apply_pack(pack, cache,
                                               with_reactions=True)
        x = jnp.stack([pack[ps._X + a] for a in range(dim)], axis=1)
        v = jnp.stack([pack[ps._V + a] for a in range(dim)], axis=1)
        x, v, rigid = integrate_rigid_fields(
            x, v, pack[ps._M], object_id, pack[ps._BD] > 0.0,
            rigid, reactions, self.params,
        )
        for a in range(dim):
            pack = (
                pack.at[ps._X + a, :].set(x[:, a])
                .at[ps._V + a, :].set(v[:, a])
            )
        return pack, rigid

    # -- public API over the pair ------------------------------------------
    def step_coupled(self, state: SimState, rigid: RigidState):
        if self.spec is None:
            state = self.bind(state)
        if getattr(self, "_coupled_jit", None) is None:
            self._coupled_jit = jax.jit(self._coupled_step_fn)
        return self._coupled_jit((state, rigid))

    def rollout_coupled(self, state: SimState, rigid: RigidState, num_steps: int):
        """``num_steps`` coupled steps in one jitted fori_loop.  With
        ``resort_every = R > 1`` on the pallas sweeps the sort/plan/meta
        rebuild runs once per R-group and the four sweeps reuse the cached
        structure in between (see _coupled_apply for why that is safe for
        moving boundaries)."""
        if self.spec is None:
            state = self.bind(state)
        R = self._amortize_R()
        if getattr(self, "_coupled_roll_jit", None) is None:
            if R > 1:
                # pack-carry R-groups (same scheme as SolverBase.rollout):
                # the substep carry is (pack, RigidState); SimState syncs
                # once per group
                from tisph.ops.pallas import sweeps as psweeps

                params = self.params

                def _roll(carry, n):
                    def outer(i, c):
                        st, rigid = c
                        st, cache = self._seg_build(st)
                        pack = psweeps.pack_state(
                            st.x, st.v, st.density, st.pressure, st.mass,
                            st.volume, st.material, cache[2], params,
                        )
                        oid = st.object_id
                        k = jnp.minimum(R, n - i * R)
                        pack, rigid = jax.lax.fori_loop(
                            0, k,
                            lambda _, pr: self._coupled_apply_pack(
                                pr[0], pr[1], oid, cache
                            ),
                            (pack, rigid),
                        )
                        return (self._seg_unpack(st, pack), rigid)

                    return jax.lax.fori_loop(0, -(-n // R), outer, carry)
            else:
                def _roll(carry, n):
                    return jax.lax.fori_loop(
                        0, n, lambda _, c: self._coupled_step_fn(c), carry
                    )
            self._coupled_roll_jit = jax.jit(_roll, static_argnums=1)
        return self._coupled_roll_jit((state, rigid), num_steps)

    def run_coupled(self, state: SimState, rigid: RigidState,
                    num_steps: int, **kw):
        """Long coupled runs with the same overflow-safe adaptive
        recapacity as SolverBase.run (window/block-pad regrow + shrink
        hysteresis + warm-wall dispatch chunking), over the
        (SimState, RigidState) carry.  Returns (state, rigid)."""
        if self.spec is None:
            state = self.bind(state)
        return self._run_adaptive(
            (state, rigid), num_steps,
            lambda c, k: self.rollout_coupled(c[0], c[1], k),
            lambda c: c[0], lambda c, s: (s, c[1]), **kw
        )
