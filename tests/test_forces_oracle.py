"""Golden-trajectory gate: the device path (sorted/CSR/stencil-run, fp32)
must track the brute-force fp64 NumPy oracle of the intended reference
equations (SURVEY.md §4c)."""

import dataclasses

import numpy as np
import jax
import pytest

import tisph as tt
from tisph.config import SolverParams
from tisph.models.state import MATERIAL_BOUNDARY, MATERIAL_FLUID, make_state

from oracle import OracleWCSPH


def _mixed_state(dim, seed, radius, domain_lo, domain_hi, n_fluid=60, n_boundary=30):
    """Random fluid cloud + a raft of boundary particles underneath."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(domain_lo) + 5 * radius
    hi = np.asarray(domain_hi) - 5 * radius
    xf = rng.uniform(lo, hi, size=(n_fluid, dim)).astype(np.float32)
    xb = rng.uniform(lo, hi, size=(n_boundary, dim)).astype(np.float32)
    x = np.concatenate([xb, xf])
    n = n_fluid + n_boundary
    mat = np.concatenate(
        [np.full(n_boundary, MATERIAL_BOUNDARY), np.full(n_fluid, MATERIAL_FLUID)]
    ).astype(np.int32)
    v = rng.normal(0, 0.5, size=(n, dim)).astype(np.float32)
    v[mat == MATERIAL_BOUNDARY] = 0
    volume0 = 0.8 * (2 * radius) ** dim
    return make_state(
        positions=x,
        velocities=v,
        densities=np.full(n, 1000.0, np.float32),
        pressures=np.zeros(n, np.float32),
        materials=mat,
        colors=np.zeros((n, 3), np.float32),
        object_ids=np.zeros(n, np.int32),
        volume0=volume0,
        capacity=n + 8,
    )


def _run_device(state, scene_dim, radius, domain_lo, domain_hi, steps):
    params = SolverParams(
        dim=scene_dim,
        support_length=4 * radius,
        particle_radius=radius,
        padding=4 * radius,
        domain_start=tuple(domain_lo),
        domain_end=tuple(domain_hi),
        gravity=(0.0, -9.81, 0.0)[:scene_dim],
        c_s=88.5,
    )
    scene = tt.SceneConfig(
        dim=scene_dim,
        domain_start=tuple(domain_lo),
        domain_end=tuple(domain_hi),
        particle_radius=radius,
        c_s=88.5,
        gravitation=(0.0, -9.81, 0.0)[:scene_dim],
    )
    solver = tt.WCSPH(scene, params=params)
    state = solver.bind(state)
    for _ in range(steps):
        state = solver.step(state)
    return jax.device_get(state)


def _run_oracle(state, dim, radius, domain_lo, domain_hi, steps):
    n = int(state.num_active)
    oracle = OracleWCSPH(
        dim=dim,
        domain_start=domain_lo,
        domain_end=domain_hi,
        particle_radius=radius,
        gravity=(0.0, -9.81, 0.0)[:dim],
    )
    x = np.asarray(state.x)[:n]
    v = np.asarray(state.v)[:n]
    rho = np.asarray(state.density)[:n]
    p = np.asarray(state.pressure)[:n]
    m = np.asarray(state.mass)[:n]
    vol = np.asarray(state.volume)[:n]
    mat = np.asarray(state.material)[:n]
    for _ in range(steps):
        x, v, rho, p, m, vol = oracle.step(x, v, rho, p, m, vol, mat)
    return x, v, rho, p


def _sorted_by_position(x, *arrays):
    key = np.lexsort(tuple(np.round(x[:, d] * 1e6) for d in range(x.shape[1] - 1, -1, -1)))
    return [x[key]] + [a[key] for a in arrays]


@pytest.mark.parametrize("dim", [2, 3])
def test_single_step_matches_oracle(dim):
    radius = 0.025
    lo, hi = [0.0] * dim, [1.0] * dim
    state0 = _mixed_state(dim, seed=42 + dim, radius=radius, domain_lo=lo, domain_hi=hi)

    dev = _run_device(state0, dim, radius, lo, hi, steps=1)
    ox, ov, orho, op = _run_oracle(state0, dim, radius, lo, hi, steps=1)

    n = int(state0.num_active)
    dx, dv, drho = np.asarray(dev.x)[:n], np.asarray(dev.v)[:n], np.asarray(dev.density)[:n]
    # Device state is resorted; compare as position-sorted multisets.
    dxs, dvs, drhos = _sorted_by_position(dx, dv, drho)
    oxs, ovs, orhos = _sorted_by_position(ox.astype(np.float32), ov, orho)

    np.testing.assert_allclose(dxs, oxs, atol=1e-5)
    np.testing.assert_allclose(dvs, ovs, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(drhos, orhos, rtol=2e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_legacy_single_step_matches_v1_oracle(dim):
    """WCSPHLegacy vs the intended-V1 float64 oracle."""
    from oracle import OracleWCSPHV1

    radius = 0.025
    lo, hi = [0.0] * dim, [1.0] * dim
    state0 = _mixed_state(dim, seed=99 + dim, radius=radius, domain_lo=lo, domain_hi=hi)

    params = SolverParams(
        dim=dim,
        support_length=4 * radius,
        particle_radius=radius,
        padding=4 * radius,
        domain_start=tuple(lo),
        domain_end=tuple(hi),
        gravity=(0.0, -9.81, 0.0)[:dim],
        c_s=88.5,
    )
    scene = tt.SceneConfig(
        dim=dim, domain_start=tuple(lo), domain_end=tuple(hi),
        particle_radius=radius, c_s=88.5,
        gravitation=(0.0, -9.81, 0.0)[:dim],
    )
    solver = tt.WCSPHLegacy(scene, params=params)
    state = solver.bind(state0)
    dev = jax.device_get(solver.step(state))

    n = int(state0.num_active)
    oracle = OracleWCSPHV1(dim=dim, domain_start=lo, domain_end=hi, particle_radius=radius)
    ox = np.asarray(state0.x)[:n]
    ov = np.asarray(state0.v)[:n]
    orho = np.asarray(state0.density)[:n]
    op = np.asarray(state0.pressure)[:n]
    ovol = np.asarray(state0.volume)[:n]
    omat = np.asarray(state0.material)[:n]
    ox, ov, orho, op, ovol = oracle.step(ox, ov, orho, op, ovol, omat)

    dxs, dvs, drhos = _sorted_by_position(
        np.asarray(dev.x)[:n], np.asarray(dev.v)[:n], np.asarray(dev.density)[:n]
    )
    oxs, ovs, orhos = _sorted_by_position(ox.astype(np.float32), ov, orho)
    np.testing.assert_allclose(dxs, oxs, atol=1e-5)
    np.testing.assert_allclose(dvs, ovs, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(drhos, orhos, rtol=2e-4)


@pytest.mark.parametrize("dim", [2])
def test_trajectory_rmse_gate(dim):
    """Multi-step divergence stays within the fp32-vs-fp64 gate
    (BASELINE: 'gated against the reference trajectory-by-trajectory')."""
    radius = 0.025
    lo, hi = [0.0] * dim, [1.0] * dim
    steps = 25
    state0 = _mixed_state(dim, seed=7, radius=radius, domain_lo=lo, domain_hi=hi)

    dev = _run_device(state0, dim, radius, lo, hi, steps=steps)
    ox, _, _, _ = _run_oracle(state0, dim, radius, lo, hi, steps=steps)

    n = int(state0.num_active)
    dxs, = _sorted_by_position(np.asarray(dev.x)[:n])
    oxs, = _sorted_by_position(ox.astype(np.float32))
    rmse = np.sqrt(((dxs - oxs) ** 2).mean())
    # Domain is 1.0 wide; require RMSE far below a particle radius.
    assert rmse < 0.1 * radius, f"trajectory RMSE {rmse:.2e}"
