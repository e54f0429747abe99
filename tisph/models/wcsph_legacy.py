"""WCSPHLegacy — the reference's V1 physics (SPHBase + WCSPH).

Differences from the V2 flagship (reference core/sph/sph_base.py +
core/sph/wcsph.py; see SURVEY.md §2.1 #5/#7):

- density: rho_i = rho0 * sum_{j fluid} m_V W   (unit-volume form with the
  scalar m_V = 0.8 d^dim; NO self-term — wcsph.py:18-32)
- non-pressure: gravity scalar g = -9.80 on the last axis (const.py:2,
  wcsph.py:59) + Laplacian-style viscosity
  2 (dim+2) nu (m_V rho0 / rho_j) (v_ij . r) / (|r|^2 + 0.01 h^2) gradW over
  ALL neighbors (sph_base.py:77-84)
- pressure: -rho0 m_V (p_i/rho_i^2 + p_j/rho_j^2) gradW for fluid j;
  for boundary j the intended Akinci term -rho0 V_j (p_i/rho_i^2) gradW
  (the reference's sph_base.py:72 reads the *velocity* field ``v[p_j]``
  where volume was intended — documented bug, SURVEY.md §7.3)
- boundary clamp: per-axis sequential displace + reflect
  (sph_base.py:89-145; the reference's v1 ``enforce_boundary`` is a silent
  no-op because :166 is missing the call parens — we run the intended clamp)
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from tisph.models.solver_base import SolverBase
from tisph.models.state import SimState, MATERIAL_FLUID
from tisph.ops import forces as F
from tisph.ops import grid as gridops
from tisph.ops.eos import tait_pressure
from tisph.ops.neighbors import sweep as neighbor_sweep


class WCSPHLegacy(SolverBase):
    def _step_fn(self, state: SimState) -> SimState:
        spec, params, scfg = self.spec, self.params, self.sweep_cfg
        h = params.support_length
        m_v = 0.8 * (2.0 * params.particle_radius) ** params.dim
        mass = m_v * params.density0  # sph_base.py:16

        state, sorted_ids, _ = gridops.sort_state_by_cell(state, spec)
        nd = gridops.build_neighbor_data(state, sorted_ids, spec, scfg)
        state = self._track_occ(state, nd.window_need)

        if self.boundary_mode == "per_step":
            volume = F.compute_boundary_volumes(state, nd, spec, params, scfg)
            state = dataclasses.replace(state, volume=volume)

        # --- density (wcsph.py:18-32): rho0 * sum m_V W over fluid j ------
        fluid_j = (state.material == MATERIAL_FLUID).astype(state.x.dtype)

        def density_pair(i, j, r_vec, r2, w, grad_w):
            return {"rho": j["fluid"] * m_v * w}

        acc = neighbor_sweep(
            nd, state.x, {}, {"fluid": fluid_j}, density_pair,
            {"rho": jnp.zeros(state.capacity, state.x.dtype)}, spec, h, scfg,
        )
        density = jnp.where(state.fluid_mask, params.density0 * acc["rho"], state.density)
        rho, pressure = tait_pressure(density, params.density0, params.stiffness, params.exponent)
        state = dataclasses.replace(state, density=rho, pressure=pressure)

        # --- forces (fused viscosity + pressure) --------------------------
        i_fields = {
            "p_rho2": state.pressure / (state.density * state.density),
            "v": state.v,
        }
        j_fields = {
            "fluid": fluid_j,
            "bound": (~state.fluid_mask & state.active_mask).astype(state.x.dtype),
            "density": state.density,
            "pressure": state.pressure,
            "volume": state.volume,
            "v": state.v,
        }

        def force_pair(i, j, r_vec, r2, w, grad_w):
            # Coefficients stay (C, cap); expanded only against grad_w.
            v_ij = i["v"] - j["v"]
            dot = jnp.sum(v_ij * r_vec, axis=-1)
            # viscosity (sph_base.py:77-84), all neighbors
            coef = (
                2.0 * (params.dim + 2) * params.viscosity
                * (mass / j["density"]) * dot / (r2 + 0.01 * h * h)
            )
            # pressure (sph_base.py:63-74, intended boundary term)
            p_term = i["p_rho2"] + j["pressure"] / (j["density"] ** 2)
            coef = coef - j["fluid"] * (params.density0 * m_v) * p_term
            coef = coef - j["bound"] * (params.density0 * j["volume"]) * i["p_rho2"]
            return {"dv": coef[..., None] * grad_w}

        gravity = jnp.zeros(params.dim, state.x.dtype).at[params.dim - 1].set(-9.80)
        init = {"dv": jnp.broadcast_to(gravity, state.x.shape).astype(state.x.dtype)}
        acc = neighbor_sweep(nd, state.x, i_fields, j_fields, force_pair, init, spec, h, scfg)
        d_velocity = jnp.where(state.fluid_mask[:, None], acc["dv"], 0.0)

        state = F.advect(state, d_velocity, params)
        if params.reference_exact:
            # sph_base.py:166 is `self.enforce_boundary_3D` WITHOUT the call
            # parens — a bare attribute access: the shipped V1 never enforces
            # the domain box at all (fluid is contained only by boundary
            # particles, and falls forever where there are none).
            return state
        return self._enforce_boundary_v1(state)

    def _enforce_boundary_v1(self, state: SimState) -> SimState:
        """Per-axis displace + reflect (intended sph_base.py:96-145):
        x += n * d then v -= (1 + c_f)(v . n) n, independently per axis —
        for axis-aligned normals this reflects each violating component."""
        params = self.params
        lo = jnp.asarray(params.domain_start, state.x.dtype) + params.padding
        hi = jnp.asarray(params.domain_end, state.x.dtype) - params.padding
        fluid = state.fluid_mask[:, None]
        out = (state.x < lo) | (state.x > hi)
        x = jnp.where(fluid, jnp.clip(state.x, lo, hi), state.x)
        v = jnp.where(
            fluid & out,
            state.v - (1.0 + params.collision_factor) * state.v,
            state.v,
        )
        return dataclasses.replace(state, x=x, v=v)
