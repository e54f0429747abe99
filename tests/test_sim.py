"""Integration tests on the shipped scenes: invariants over a rollout
(SURVEY.md §4d: no NaN, particles inside domain, density clamped, boundary
particles static)."""

import numpy as np
import jax
import pytest

import tisph as tt
from tisph.models.state import MATERIAL_BOUNDARY


def _run(scene_path, steps, solver_cls=tt.WCSPH):
    scene = tt.load_scene(scene_path)
    state = tt.build_state(scene)
    solver = solver_cls(scene)
    state = solver.bind(state)
    state = solver.rollout(state, steps)
    return scene, solver, jax.device_get(state)


def test_2d_dam_break_invariants():
    scene, solver, state = _run("scenes/demo_2d.json", steps=60)
    n = int(state.num_active)
    x, v = np.asarray(state.x)[:n], np.asarray(state.v)[:n]
    assert np.isfinite(x).all() and np.isfinite(v).all()
    lo = np.asarray(scene.domain_start) + scene.padding
    hi = np.asarray(scene.domain_end) - scene.padding
    assert (x >= lo - 1e-5).all() and (x <= hi + 1e-5).all()
    rho = np.asarray(state.density)[:n]
    assert (rho >= scene.density0 - 1e-3).all()  # post-clamp invariant
    # fluid should be falling under gravity
    m = jax.device_get(solver.metrics(state))
    assert float(m["max_velocity"]) > 0.5
    assert float(m["nan_count"]) == 0
    assert float(m["max_run_length"]) <= float(m["run_cap"])


def test_3d_dam_break_smoke():
    """demo_3d scene is ~189k particles — too big for CPU CI; shrink it."""
    import json, tempfile, os

    with open("scenes/demo_3d.json") as f:
        raw = json.load(f)
    raw["configuration"]["particleRadius"] = 0.04  # ~3k particles
    with tempfile.TemporaryDirectory() as td:
        p = os.path.join(td, "small3d.json")
        with open(p, "w") as f:
            json.dump(raw, f)
        scene, solver, state = _run(p, steps=30)
    n = int(state.num_active)
    x = np.asarray(state.x)[:n]
    assert np.isfinite(x).all()
    lo = np.asarray(scene.domain_start) + scene.padding
    hi = np.asarray(scene.domain_end) - scene.padding
    assert (x >= lo - 1e-5).all() and (x <= hi + 1e-5).all()


def test_boundary_particles_never_move():
    """Static boundary raft must stay put while fluid falls onto it."""
    import json, tempfile, os

    raw = {
        "configuration": {
            "dim": 2,
            "domainStart": [0.0, 0.0],
            "domainEnd": [2.0, 2.0],
            "particleRadius": 0.02,
            "density0": 1000,
            "gravitation": [0.0, -9.81],
            "c_s": 50.0,
        },
        "fluidBlocks": [
            {"start": [0.5, 0.8], "end": [0.9, 1.2], "velocity": [0.0, -1.0],
             "density": 1000.0, "color": [50, 100, 200]}
        ],
        "rigidBodies": [],
    }
    scene = tt.scene_from_dict(raw)
    state = tt.build_state(scene)
    # Add a boundary raft manually (below the fluid).
    import tisph.geometry.sampler as sampler
    from tisph.models.state import make_state

    raft = sampler.cube_lattice([0.3, 0.3], [1.1, 0.4], scene.particle_radius)
    nb = raft.shape[0]
    fluid = sampler.cube_lattice([0.5, 0.8], [0.9, 1.2], scene.particle_radius)
    nf = fluid.shape[0]
    n = nb + nf
    state = make_state(
        positions=np.concatenate([raft, fluid]),
        velocities=np.concatenate([np.zeros((nb, 2)), np.tile([0.0, -1.0], (nf, 1))]).astype(np.float32),
        densities=np.full(n, 1000.0, np.float32),
        pressures=np.zeros(n, np.float32),
        materials=np.concatenate([np.zeros(nb), np.ones(nf)]).astype(np.int32),
        colors=np.zeros((n, 3), np.float32),
        object_ids=np.zeros(n, np.int32),
        volume0=scene.particle_volume0,
    )
    solver = tt.WCSPH(scene)
    state = solver.bind(state)
    out = jax.device_get(solver.rollout(state, 40))
    mat = np.asarray(out.material)
    x = np.asarray(out.x)
    v = np.asarray(out.v)
    bmask = mat == MATERIAL_BOUNDARY
    assert bmask.sum() == nb
    # boundary set of positions unchanged (order may differ after resort)
    orig = raft[np.lexsort(raft.T)]
    now = x[bmask][np.lexsort(x[bmask].T)]
    np.testing.assert_allclose(now, orig, atol=1e-6)
    assert np.abs(v[bmask]).max() == 0.0
    # boundary volume was updated by the Akinci pass
    vol_b = np.asarray(out.volume)[bmask]
    assert (vol_b != scene.particle_volume0).any()


def test_run_auto_recapacity():
    """solver.run grows the window cap when fluid compaction overflows it
    (the reference corrupts memory on cell overflow instead,
    partice_systemv3.py:214-217)."""
    from tisph.ops.neighbors import SweepConfig

    scene = tt.load_scene("scenes/demo_2d.json")
    state = tt.build_state(scene)
    # deliberately undersized window
    solver = tt.WCSPH(
        scene, sweep_cfg=SweepConfig(impl="blocked", block_size=128, window_cap=128)
    )
    state = solver.bind(state)
    m0 = jax.device_get(solver.metrics(state))
    assert int(m0["max_run_length"]) > 128  # initial state already overflows
    state = solver.run(state, 30, check_every=10)
    assert solver.sweep_cfg.window_cap > 128
    m = jax.device_get(solver.metrics(state))
    assert int(m["max_run_length"]) <= int(m["run_cap"])
    assert int(m["nan_count"]) == 0


def test_legacy_solver_runs():
    scene, solver, state = _run("scenes/demo_2d.json", steps=20, solver_cls=tt.WCSPHLegacy)
    n = int(state.num_active)
    assert np.isfinite(np.asarray(state.x)[:n]).all()


def test_legacy_solver_with_pallas_config():
    """Regression: a pallas SweepConfig (the GPU auto-default) must fall
    back to the generic blocked path for non-WCSPH sweeps instead of
    raising 'unknown sweep impl'."""
    from tisph.ops.neighbors import SweepConfig

    scene = tt.load_scene("scenes/demo_2d.json")
    state = tt.build_state(scene)
    solver = tt.WCSPHLegacy(
        scene,
        sweep_cfg=SweepConfig(impl="pallas", block_size=128, window_cap=512,
                              interpret=True),
    )
    state = solver.bind(state)
    state = solver.step(state)
    out = jax.device_get(state)
    n = int(out.num_active)
    assert np.isfinite(np.asarray(out.x)[:n]).all()


def test_overflow_caught_within_one_dispatch():
    """Per-dispatch overflow flag (state.occ_window): an undersized window
    must be detected and re-capacitated on the FIRST dispatch even when the
    metrics check interval is far larger than the run (VERDICT r1 #6 — the
    old run() only sampled occupancy every check_every steps)."""
    from tisph.ops.neighbors import SweepConfig

    scene = tt.load_scene("scenes/demo_2d.json")
    state = tt.build_state(scene)
    solver = tt.WCSPH(
        scene, sweep_cfg=SweepConfig(impl="blocked", block_size=128, window_cap=128)
    )
    state = solver.bind(state)
    # a run far SHORTER than any check interval still triggers the regrow
    state = solver.run(state, 2, check_every=10_000)
    assert solver.sweep_cfg.window_cap > 128
    # after the check, the running max is reset
    assert int(jax.device_get(state.occ_window)) == 0


def test_occ_window_tracks_required_window():
    """state.occ_window after a step equals the longest block window the
    step's neighbor structure required (computed independently here)."""
    import jax.numpy as jnp
    from tisph.ops import grid as gridops
    from tisph.ops.neighbors import SweepConfig

    scene = tt.load_scene("scenes/demo_2d.json")
    state = tt.build_state(scene)
    solver = tt.WCSPH(
        scene, sweep_cfg=SweepConfig(impl="blocked", block_size=128, window_cap=2048)
    )
    state = solver.bind(state)
    state1 = solver.step(state)
    occ = int(jax.device_get(state1.occ_window))

    # independent recomputation on the PRE-step sorted configuration
    st_s, ids, _ = gridops.sort_state_by_cell(state, solver.spec)
    coords = gridops.cell_coords(st_s.x, solver.spec)
    s, e = gridops.block_window_bounds(ids, coords, solver.spec, 128)
    need = int(jax.device_get(jnp.max(jnp.maximum(e - s, 0))))
    assert occ == need
    assert 0 < occ <= 2048
