"""WCSPH physics sweeps (jnp reference tier).

Implements the *intended* physics of the reference's V2 solver stack
(core/sph/sph_basev2.py + core/sph/wcsphv2.py).  Where the reference is
self-evidently broken the standard equation is used and the divergence is
documented inline (policy per SURVEY.md §7.3):

- wcsphv2.py:28-34 discards the neighbor density sum (overwrites with the
  self term) and its density task (:18-25) mixes up i/j mass and material —
  here density is the standard summation over neighbors.
- sph_basev2.py:145 reflects the z overflow with ``pos[1]`` (copy-paste);
  here each axis uses its own coordinate.

The non-pressure and pressure interactions are fused into ONE neighbor
sweep: pressure depends only on per-particle density/pressure, which are
computed before the sweep, so both force families share a single gather of
the j-side fields — halving HBM traffic versus the reference's two separate
kernels (wcsphv2.py:43-54 and :83-93).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from tisph.config import SolverParams
from tisph.models.state import (
    SimState,
    MATERIAL_BOUNDARY,
    MATERIAL_FLUID,
)
from tisph.ops.eos import tait_pressure
from tisph.ops.grid import GridSpec
from tisph.ops.kernels import cubic_kernel
from tisph.ops.neighbors import NeighborData, SweepConfig, sweep



# ---------------------------------------------------------------------------
# Pair-interaction kernel factories.
#
# Each factory returns (i_fields_of, j_fields_of, pair_fn, init_of) where the
# *_of callables map a dict of raw particle arrays {x, v, density, pressure,
# mass, volume, material} to the sweep inputs.  The single-device wrappers
# below and the multi-chip sharded step (tisph/parallel/domain.py) share
# these, so the physics exists exactly once.
# ---------------------------------------------------------------------------


def _flags(material: jax.Array, dtype) -> tuple[jax.Array, jax.Array]:
    fluid = (material == MATERIAL_FLUID).astype(dtype)
    bound = (material == MATERIAL_BOUNDARY).astype(dtype)
    return fluid, bound


def boundary_volume_kernel(params: SolverParams, spec: GridSpec):
    """Akinci boundary volume delta sum (sph_basev2.py:190-201)."""
    h = params.support_length
    w0 = cubic_kernel(jnp.zeros(()), h, spec.dim)

    def i_fields_of(f):
        return {}

    def j_fields_of(f):
        _, bd = _flags(f["material"], f["x"].dtype)
        return {"is_b": bd}

    def pair(i, j, r_vec, r2, w, grad_w):
        return {"delta": j["is_b"] * w}

    def init_of(f):
        return {"delta": jnp.full(f["x"].shape[:1], w0, f["x"].dtype)}

    return i_fields_of, j_fields_of, pair, init_of


def density_kernel(params: SolverParams, spec: GridSpec):
    """Density summation terms (intended wcsphv2.py:18-34)."""
    h = params.support_length
    w0 = cubic_kernel(jnp.zeros(()), h, spec.dim)

    def i_fields_of(f):
        return {}

    def j_fields_of(f):
        fl, bd = _flags(f["material"], f["x"].dtype)
        return {"eff_mass": fl * f["mass"] + bd * (params.density0 * f["volume"])}

    def pair(i, j, r_vec, r2, w, grad_w):
        return {"rho": j["eff_mass"] * w}

    def init_of(f):
        return {"rho": f["mass"] * w0}

    return i_fields_of, j_fields_of, pair, init_of


def force_kernel(params: SolverParams, spec: GridSpec):
    """Fused non-pressure + pressure terms (wcsphv2.py:56-93,
    sph_basev2.py:64-78)."""
    h = params.support_length

    def i_fields_of(f):
        return {
            "rho": f["density"],
            "p_rho2": f["pressure"] / (f["density"] * f["density"]),
            "inv_m": 1.0 / jnp.maximum(f["mass"], 1e-30),
            "v": f["v"],
        }

    def j_fields_of(f):
        fl, bd = _flags(f["material"], f["x"].dtype)
        return {
            "fluid": fl,
            "bound": bd,
            "mass": f["mass"],
            "volume": f["volume"],
            "density": f["density"],
            "pressure": f["pressure"],
            "v": f["v"],
        }

    def pair(i, j, r_vec, r2, w, grad_w):
        # Coefficients stay (B, W); expanded to (B, W, 1) only for the
        # final multiply against r_vec / grad_w.
        fl = j["fluid"]
        bd = j["bound"]
        m_j = j["mass"]
        rho_j = j["density"]
        bvol_j = params.density0 * j["volume"]
        rho_i = i["rho"]          # (B, 1)
        p_rho2_i = i["p_rho2"]    # (B, 1)
        v_ij = i["v"] - j["v"]    # (B, W, dim)
        dot = jnp.sum(v_ij * r_vec, axis=-1)  # v_ij . x_ij, (B, W)
        inv_denom = 1.0 / (r2 + 0.01 * h * h)
        dot_neg = jnp.minimum(dot, 0.0) * inv_denom

        # Cohesion surface tension (wcsphv2.py:61-65).
        coh_coef = -(params.surface_tension * i["inv_m"]) * fl * m_j * w

        # Monaghan artificial viscosity, fluid j (wcsphv2.py:68-73).
        nu_f = (2.0 * params.viscosity * h * params.c_s) / (rho_i + rho_j)
        grad_coef = fl * m_j * nu_f * dot_neg  # = -m_j * pi_f

        # Akinci boundary viscosity, sigma = 0.08 (wcsphv2.py:74-80).
        nu_b = params.boundary_sigma * h * params.c_s / (2.0 * rho_i)
        grad_coef = grad_coef + bd * bvol_j * nu_b * dot_neg

        # Symmetric pressure gradient (sph_basev2.py:64-78).
        p_term_f = p_rho2_i + j["pressure"] / (rho_j * rho_j)
        grad_coef = grad_coef - fl * m_j * p_term_f
        grad_coef = grad_coef - bd * bvol_j * p_rho2_i

        return {"dv": coh_coef[..., None] * r_vec + grad_coef[..., None] * grad_w}

    def init_of(f):
        gravity = jnp.asarray(params.gravity, dtype=f["x"].dtype)
        return {"dv": jnp.broadcast_to(gravity, f["x"].shape).astype(f["x"].dtype)}

    return i_fields_of, j_fields_of, pair, init_of


def rigid_reaction_kernel(params: SolverParams, spec: GridSpec):
    """Reaction force of the fluid on boundary particles (Akinci two-way
    coupling).  For fluid f receiving boundary-term acceleration
    a_f = rho0 V_b (nu_b dot_neg - p_f/rho_f^2) gradW_fb, the reaction on
    boundary particle b is  F_b = sum_f m_f rho0 V_b
    (nu_b(rho_f) dot_neg - p_f/rho_f^2) gradW_bf  (gradW antisymmetric,
    dot_neg symmetric).  Units: force (the fluid side is an acceleration;
    multiplied by m_f here)."""
    h = params.support_length

    def i_fields_of(f):
        return {"bvol": params.density0 * f["volume"], "v": f["v"]}

    def j_fields_of(f):
        fl, _ = _flags(f["material"], f["x"].dtype)
        return {
            "fluid": fl,
            "mass": f["mass"],
            "density": f["density"],
            "p_rho2": f["pressure"] / jnp.maximum(f["density"] ** 2, 1e-12),
            "v": f["v"],
        }

    def pair(i, j, r_vec, r2, w, grad_w):
        v_ij = i["v"] - j["v"]
        dot = jnp.sum(v_ij * r_vec, axis=-1)
        dot_neg = jnp.minimum(dot, 0.0) / (r2 + 0.01 * h * h)
        nu_b = params.boundary_sigma * h * params.c_s / (2.0 * j["density"])
        coef = j["fluid"] * j["mass"] * i["bvol"] * (nu_b * dot_neg - j["p_rho2"])
        return {"f": coef[..., None] * grad_w}

    def init_of(f):
        return {"f": jnp.zeros_like(f["x"])}

    return i_fields_of, j_fields_of, pair, init_of


def compute_rigid_reactions(
    state: SimState,
    nd,
    spec: GridSpec,
    params: SolverParams,
    sweep_cfg: SweepConfig = SweepConfig(),
) -> jax.Array:
    """Per-particle fluid->boundary reaction forces (zero on non-boundary)."""
    i_of, j_of, pair, init_of = rigid_reaction_kernel(params, spec)
    f = state_fields(state)
    acc = sweep(
        nd, state.x, i_of(f), j_of(f), pair, init_of(f),
        spec, params.support_length, sweep_cfg,
    )
    return jnp.where(state.boundary_mask[:, None], acc["f"], 0.0)


def state_fields(state: SimState) -> dict:
    return {
        "x": state.x,
        "v": state.v,
        "density": state.density,
        "pressure": state.pressure,
        "mass": state.mass,
        "volume": state.volume,
        "material": state.material,
    }


def compute_boundary_volumes(
    state: SimState,
    nd: NeighborData,
    spec: GridSpec,
    params: SolverParams,
    sweep_cfg: SweepConfig = SweepConfig(),
) -> jax.Array:
    """Akinci boundary-particle volume V_b = 1 / sum_b W.

    Reference: sph_basev2.py:190-201 — delta_bi starts from W(0) and sums W
    over *boundary* neighbors only; recomputed every step (:212).  Fluid
    particles keep their previous (V0) volume.
    """
    i_of, j_of, pair, init_of = boundary_volume_kernel(params, spec)
    f = state_fields(state)
    acc = sweep(
        nd, state.x, i_of(f), j_of(f), pair, init_of(f),
        spec, params.support_length, sweep_cfg,
    )
    vol_b = 1.0 / jnp.maximum(acc["delta"], 1e-10)
    return jnp.where(state.boundary_mask, vol_b, state.volume)


def compute_densities(
    state: SimState,
    nd: NeighborData,
    spec: GridSpec,
    params: SolverParams,
    sweep_cfg: SweepConfig = SweepConfig(),
) -> jax.Array:
    """Density summation for fluid particles.

    rho_i = m_i W(0) + sum_{j fluid} m_j W + sum_{j boundary} rho0 V_j W
    (intended form of wcsphv2.py:18-34 with the Akinci boundary term).
    Boundary particles keep their initial density, as in the reference
    (its density kernel skips material != fluid).
    """
    i_of, j_of, pair, init_of = density_kernel(params, spec)
    f = state_fields(state)
    acc = sweep(
        nd, state.x, i_of(f), j_of(f), pair, init_of(f),
        spec, params.support_length, sweep_cfg,
    )
    return jnp.where(state.fluid_mask, acc["rho"], state.density)


def compute_pressures(
    density: jax.Array, params: SolverParams
) -> tuple[jax.Array, jax.Array]:
    """Clamp + Tait EOS for all particles (wcsphv2.py:44-48 applies it to
    every particle; a boundary particle at rest density gets p = 0)."""
    return tait_pressure(density, params.density0, params.stiffness, params.exponent)


def apply_density_mode(
    rho: jax.Array, state: SimState, params: SolverParams
) -> jax.Array:
    """``reference_exact`` V2 density bug: the reference's neighbor
    accumulation lands in the aliased field element and is then OVERWRITTEN
    with the self term alone (wcsphv2.py:29-34 — ``density = m_i W(0)``
    before the loop, ``ps.density[p_i] = density`` after it).  Fluid density
    is therefore the constant m_i W(0) ~= 318 kg/m^3 every step; the EOS
    clamp (wcsphv2.py:45) then pins it to rho0 and pressure to exactly 0 —
    the shipped WCSPHV2 runs with NO pressure forces.  The intended mode
    returns the summation unchanged."""
    if not params.reference_exact:
        return rho
    from tisph.ops.kernels import cubic_kernel_sigma

    w0 = cubic_kernel_sigma(params.dim, params.support_length)
    return jnp.where(state.fluid_mask, state.mass * w0, rho)


def compute_forces(
    state: SimState,
    nd: NeighborData,
    spec: GridSpec,
    params: SolverParams,
    sweep_cfg: SweepConfig = SweepConfig(),
) -> jax.Array:
    """Fused non-pressure + pressure acceleration for fluid particles.

    Terms (reference wcsphv2.py:56-93 and sph_basev2.py:64-78):
      gravity            g (config vector, wcsphv2.py:90-91)
      cohesion           -(st/m_i) m_j r W(|r|)              [fluid j]
      artificial visc.   -m_j Pi_ij gradW, Monaghan form     [fluid j]
      boundary visc.     -rho0 V_j Pi_b gradW, sigma=0.08    [boundary j]
      pressure           -m_j (p_i/rho_i^2 + p_j/rho_j^2) gradW      [fluid j]
      boundary pressure  -rho0 V_j (p_i/rho_i^2) gradW               [boundary j]
    """
    i_of, j_of, pair, init_of = force_kernel(params, spec)
    f = state_fields(state)
    acc = sweep(
        nd, state.x, i_of(f), j_of(f), pair, init_of(f),
        spec, params.support_length, sweep_cfg,
    )
    return jnp.where(state.fluid_mask[:, None], acc["dv"], 0.0)


def advect(state: SimState, d_velocity: jax.Array, params: SolverParams) -> SimState:
    """Symplectic Euler, fluid only (wcsphv2.py:95-100)."""
    fluid = state.fluid_mask[:, None]
    v = jnp.where(fluid, state.v + params.dt * d_velocity, state.v)
    x = jnp.where(fluid, state.x + params.dt * v, state.x)
    return dataclasses.replace(state, x=x, v=v)


def enforce_domain_boundary(state: SimState, params: SolverParams) -> SimState:
    """Domain-box clamp with combined collision normal.

    Reference sph_basev2.py:158-189 (``enforce_boundary_3D_v1``): clamp each
    axis into [padding, domain_size - padding], accumulate a collision
    normal, then reflect: v -= (1 + c_f) (v . n) n.  Here the clamp is
    expressed against absolute [start + padding, end - padding] (the
    reference assumes domain_start = 0) and each axis reflects on its own
    coordinate (fixing the reference's z-axis ``pos[1]`` copy-paste at
    sph_basev2.py:145 / sph_base.py:141).
    """
    lo = jnp.asarray(params.domain_start, dtype=state.x.dtype) + params.padding
    hi = jnp.asarray(params.domain_end, dtype=state.x.dtype) - params.padding
    fluid = state.fluid_mask[:, None]

    over_hi = state.x > hi
    under_lo = state.x <= lo
    normal = jnp.where(over_hi, 1.0, 0.0) + jnp.where(under_lo, -1.0, 0.0)
    x_clamped = jnp.clip(state.x, lo, hi)
    x = jnp.where(fluid, x_clamped, state.x)

    n_len = jnp.sqrt(jnp.sum(normal * normal, axis=-1, keepdims=True))
    n_hat = normal / jnp.maximum(n_len, 1e-6)
    v_dot_n = jnp.sum(state.v * n_hat, axis=-1, keepdims=True)
    v_reflected = state.v - (1.0 + params.collision_factor) * v_dot_n * n_hat
    v = jnp.where(fluid & (n_len > 1e-6), v_reflected, state.v)

    return dataclasses.replace(state, x=x, v=v)
