"""Triton-route Pallas sweep kernels (interpret mode on CPU): sweep outputs
must match the brute-force oracle / the jnp blocked sweep on the identical
sorted state, and a full Pallas step the float64 oracle.  (Multi-step
trajectory comparisons are meaningless here: the stiff Tait EOS amplifies
mere summation-order noise.)"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tisph as tt
from tisph.models.state import pad_state_capacity
from tisph.ops import forces as F
from tisph.ops import grid as gridops
from tisph.ops.kernels import cubic_kernel
from tisph.ops.neighbors import SweepConfig
from tisph.ops.pallas import sweeps as ps


def _scene(dim=3, radius=0.04):
    return tt.scene_from_dict(
        {
            "configuration": {
                "dim": dim,
                "domainStart": [0.0] * dim,
                "domainEnd": [1.0] * dim,
                "particleRadius": radius,
                "density0": 1000,
                "gravitation": ([0.0, -9.81, 0.0])[:dim],
                "c_s": 50.0,
            },
            "fluidBlocks": [
                {"start": [0.15] * dim, "end": [0.55] * dim,
                 "velocity": ([0.2, -1.0, 0.5])[:dim], "density": 1000.0,
                 "color": [50, 100, 200]}
            ],
            "rigidBodies": [],
        }
    )


def _pallas_solver(scene, window_cap=1024, **kw):
    return tt.WCSPH(
        scene,
        sweep_cfg=SweepConfig(impl="pallas", block_size=128,
                              window_cap=window_cap, interpret=True),
        **kw,
    )


def _sorted_setup(solver, state):
    """Sorted state + seg structure + pack for one sweep call."""
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg
    state_s, ids, _ = gridops.sort_state_by_cell(state, spec)
    plan = gridops.seg_plan(ids, spec, scfg.block_size,
                            scfg.pad_capacity // scfg.block_size)
    meta, _ = ps.seg_block_meta(plan, ids, spec, scfg.block_size,
                                scfg.window_cap)
    pack = ps.pack_state(
        state_s.x, state_s.v, state_s.density, state_s.pressure,
        state_s.mass, state_s.volume, state_s.material, ids, params,
    )
    return state_s, ids, meta, pack


def _bound(scene, cap=2048):
    solver = _pallas_solver(scene)
    state = solver.bind(pad_state_capacity(tt.build_state(scene), cap))
    return (solver,) + _sorted_setup(solver, state)


def _brute_density(state_s, h, dim):
    x = np.asarray(state_s.x, dtype=np.float64)
    act = np.asarray(state_s.material) != -1
    m = np.asarray(state_s.mass)
    n = x.shape[0]
    d = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
    nb = (d < h) & ~np.eye(n, dtype=bool) & act[None, :] & act[:, None]
    w = np.asarray(cubic_kernel(jnp.asarray(d.reshape(-1), jnp.float32),
                                h, dim)).reshape(n, n)
    w0 = float(cubic_kernel(jnp.zeros(()), h, dim))
    return m * w0 + (w * nb * m[None, :]).sum(1)


@pytest.mark.parametrize("dim", [2, 3])
def test_density_sweep_matches_bruteforce(dim):
    scene = _scene(dim=dim)
    solver, state_s, ids, meta, pack = _bound(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg

    rho_p = np.asarray(ps.density_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=True))
    rho_brute = _brute_density(state_s, params.support_length, dim)
    fluid = np.asarray(state_s.material) == 1
    np.testing.assert_allclose(rho_p[fluid], rho_brute[fluid], rtol=2e-5)


def test_force_sweep_matches_blocked():
    scene = _scene()
    solver, state_s, ids, meta, pack = _bound(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg

    # realistic densities/pressures via the blocked path + EOS
    scfg_b = SweepConfig(impl="blocked", block_size=128, window_cap=1024)
    nd = gridops.build_neighbor_data(state_s, ids, spec, scfg_b)
    rho = F.compute_densities(state_s, nd, spec, params, scfg_b)
    rho, p = F.compute_pressures(rho, params)
    state_s = dataclasses.replace(state_s, density=rho, pressure=p)
    pack = ps.repack_eos(pack, rho, p)

    dv_b = np.asarray(F.compute_forces(state_s, nd, spec, params, scfg_b))
    dv_p = np.asarray(ps.force_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=True))
    fluid = np.asarray(state_s.material) == 1
    scale = np.abs(dv_b[fluid]).max()
    np.testing.assert_allclose(
        dv_p[fluid] / scale, dv_b[fluid] / scale, atol=5e-6
    )


def test_density_matches_bruteforce_mid_collapse():
    """Density sweep vs brute force on an EVOLVED (clustered, piled-up)
    state — the regime where windows grow and sparse-row blocks straddle
    several grid rows."""
    scene = _scene(radius=0.045)
    solver = _pallas_solver(scene, window_cap=1536)
    state = solver.bind(pad_state_capacity(tt.build_state(scene), 1536))
    for _ in range(12):
        state = solver.step(state)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg
    state_s, ids, meta, pack = _sorted_setup(solver, state)
    rho_p = np.asarray(ps.density_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=True))
    rho_brute = _brute_density(state_s, params.support_length, 3)
    fluid = np.asarray(state_s.material) == 1
    np.testing.assert_allclose(rho_p[fluid], rho_brute[fluid], rtol=3e-5)


def test_sweeps_with_boundary_particles():
    """Density AND force sweeps on a mixed fluid/boundary state must match
    the (oracle-gated) blocked sweeps: the boundary rows exercise the
    effm/bd pack lanes the fluid-only cases never touch."""
    raw = {
        "configuration": {
            "dim": 3, "domainStart": [0.0] * 3, "domainEnd": [1.0] * 3,
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0], "c_s": 50.0,
        },
        "boundaryBlocks": [
            {"start": [0.3, 0.05, 0.3], "end": [0.7, 0.2, 0.7]}
        ],
        "fluidBlocks": [
            {"start": [0.25, 0.22, 0.25], "end": [0.6, 0.55, 0.6],
             "velocity": [0.2, -1.0, 0.5], "density": 1000.0,
             "color": [50, 100, 200]}
        ],
        "rigidBodies": [],
    }
    scene = tt.scene_from_dict(raw)
    solver, state_s, ids, meta, pack = _bound(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg
    assert (np.asarray(state_s.material) == 0).any()

    scfg_b = SweepConfig(impl="blocked", block_size=128, window_cap=1024)
    nd = gridops.build_neighbor_data(state_s, ids, spec, scfg_b)
    rho_b = np.asarray(F.compute_densities(state_s, nd, spec, params, scfg_b))
    rho_p = np.asarray(ps.density_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=True))
    fluid = np.asarray(state_s.material) == 1
    np.testing.assert_allclose(rho_p[fluid], rho_b[fluid], rtol=2e-5)

    rho, p = F.compute_pressures(jnp.asarray(rho_b), params)
    state_s = dataclasses.replace(state_s, density=rho, pressure=p)
    pack = ps.repack_eos(pack, rho, p)
    dv_b = np.asarray(F.compute_forces(state_s, nd, spec, params, scfg_b))
    dv_p = np.asarray(ps.force_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=True))
    scale = np.abs(dv_b[fluid]).max()
    np.testing.assert_allclose(
        dv_p[fluid] / scale, dv_b[fluid] / scale, atol=5e-6
    )


def test_pallas_step_runs():
    """Full jitted pallas step (interpret) stays finite and in-domain."""
    scene = _scene()
    solver = _pallas_solver(scene)
    state = solver.bind(tt.build_state(scene))
    for _ in range(5):
        state = solver.step(state)
    out = jax.device_get(state)
    act = np.asarray(out.material) != -1
    x = np.asarray(out.x)[act]
    assert np.isfinite(x).all()
    assert (x >= 0).all() and (x <= 1).all()


def check_step_against_oracle(dim, interpret):
    """One Pallas step against the brute-force float64 oracle of the
    intended equations, on a mixed fluid/boundary cloud."""
    from test_forces_oracle import (
        _mixed_state, _run_oracle, _sorted_by_position,
    )

    radius = 0.025
    lo, hi = [0.0] * dim, [1.0] * dim
    state0 = _mixed_state(dim, seed=42 + dim, radius=radius,
                          domain_lo=lo, domain_hi=hi)
    scene = tt.SceneConfig(
        dim=dim, domain_start=tuple(lo), domain_end=tuple(hi),
        particle_radius=radius, c_s=88.5,
        gravitation=(0.0, -9.81, 0.0)[:dim],
    )
    params = tt.SolverParams(
        dim=dim, support_length=4 * radius, particle_radius=radius,
        padding=4 * radius, domain_start=tuple(lo), domain_end=tuple(hi),
        gravity=(0.0, -9.81, 0.0)[:dim], c_s=88.5,
    )
    solver = tt.WCSPH(scene, params=params, sweep_cfg=SweepConfig(
        impl="pallas", block_size=128, window_cap=512, interpret=interpret))
    dev = jax.device_get(solver.step(solver.bind(state0)))
    ox, ov, orho, _ = _run_oracle(state0, dim, radius, lo, hi, steps=1)

    n = int(state0.num_active)
    act = np.asarray(dev.material) != -1
    dxs, dvs, drhos = _sorted_by_position(
        np.asarray(dev.x)[act], np.asarray(dev.v)[act],
        np.asarray(dev.density)[act])
    oxs, ovs, orhos = _sorted_by_position(ox.astype(np.float32), ov, orho)
    assert dxs.shape[0] == n
    np.testing.assert_allclose(dxs, oxs, atol=1e-5)
    np.testing.assert_allclose(dvs, ovs, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(drhos, orhos, rtol=2e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_pallas_step_matches_oracle(dim):
    check_step_against_oracle(dim, interpret=True)
