"""Dynamic rigid bodies (two-way coupling) — a capability beyond the
reference.  The fluid-coupled gates run under ``-m slow`` here (CPU
coupled-step compiles are minutes each).  The default suite covers the
integrator +
reaction machinery with the fast free-fall case and the seg-vs-blocked
coupled-step equivalence gate.

Run the slow set explicitly:  python -m pytest tests -m slow
"""

import json

import numpy as np
import jax
import pytest

import tisph as tt
from tisph.models.state import MATERIAL_BOUNDARY
from tisph.models.wcsph_rigid import WCSPHRigid


def _build(tmp_path, body_density, body_lo, body_hi, fluid=None, radius=0.025):
    from tisph.geometry.mesh import box_mesh, save_obj

    mesh_path = tmp_path / "box.obj"
    save_obj(box_mesh(body_lo, body_hi), mesh_path)
    raw = {
        "configuration": {
            "dim": 3,
            "domainStart": [0.0, 0.0, 0.0],
            "domainEnd": [1.0, 1.0, 1.0],
            "particleRadius": radius,
            "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0],
            "c_s": 40.0,
        },
        "rigidBodies": [
            {"geometryFile": str(mesh_path), "scale": [1, 1, 1],
             "translation": [0, 0, 0], "rotationAngle": 0,
             "rotationAxis": [0, 1, 0], "velocity": [0, 0, 0],
             "density": body_density, "color": [150, 150, 150],
             "isDynamic": True}
        ],
        "fluidBlocks": fluid or [],
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(raw))
    scene = tt.load_scene(p)
    state = tt.build_state(scene)
    solver = WCSPHRigid(scene)
    state = solver.bind(state)
    rigid = solver.init_rigid(state)
    return scene, solver, state, rigid


def test_free_fall_without_fluid(tmp_path):
    """No fluid: the body must free-fall at g (no spin, no drift) and the
    coupled step machinery (reaction sweep included) must compile/run."""
    scene, solver, state, rigid = _build(
        tmp_path, 1000.0, (0.45, 0.7, 0.45), (0.55, 0.8, 0.55)
    )
    steps = 50
    y0 = float(jax.device_get(rigid.com)[0, 1])
    state, rigid = solver.rollout_coupled(state, rigid, steps)
    r = jax.device_get(rigid)
    t = steps * solver.params.dt
    np.testing.assert_allclose(float(r.v_com[0, 1]), -9.81 * t, rtol=1e-3)
    assert abs(float(r.v_com[0, 0])) < 1e-4 and abs(float(r.v_com[0, 2])) < 1e-4
    assert float(r.com[0, 1]) < y0
    assert np.abs(np.asarray(r.omega)).max() < 1e-3
    # rigidity: particle distances to COM preserved
    host = jax.device_get(state)
    sel = (np.asarray(host.object_id) == 0) & (np.asarray(host.material) == MATERIAL_BOUNDARY)
    com = np.asarray(r.com)[0]
    d = np.linalg.norm(np.asarray(host.x)[sel] - com, axis=1)
    assert d.max() < 0.12  # body diagonal bound; no explosion


_POOL = [
    {"start": [0.09, 0.09, 0.09], "end": [0.91, 0.45, 0.91],
     "velocity": [0, 0, 0], "density": 1000.0, "color": [50, 100, 200],
     "spacing": "diameter"}
]


@pytest.mark.slow
@pytest.mark.parametrize("density,expect_above", [(200.0, True), (5000.0, False)])
def test_buoyancy(tmp_path, density, expect_above):
    """A light box dropped into a calm diameter-spaced pool floats near the
    surface; a heavy one sinks to the floor.  (Values from an
    earlier run: light com_y≈0.34, heavy≈0.18 after 0.4 s.)"""
    scene, solver, state, rigid = _build(
        tmp_path, density, (0.42, 0.5, 0.42), (0.58, 0.62, 0.58),
        fluid=_POOL, radius=0.02,
    )
    state, rigid = solver.rollout_coupled(state, rigid, 2000)
    r = jax.device_get(rigid)
    com_y = float(r.com[0, 1])
    if expect_above:
        assert com_y > 0.27, f"light body should float, com_y={com_y}"
    else:
        assert com_y < 0.27, f"heavy body should sink, com_y={com_y}"
    out = jax.device_get(state)
    act = np.asarray(out.material) != -1
    assert np.isfinite(np.asarray(out.x)[act]).all()


def test_seg_coupled_matches_blocked(tmp_path):
    """The pallas seg coupled step (all four sweeps as seg kernels) must
    reproduce the jnp blocked coupled step on the identical state."""
    import dataclasses

    from tisph.models.state import pad_state_capacity
    from tisph.ops.neighbors import SweepConfig

    scene, solver_b, state0, rigid0 = _build(
        tmp_path, 400.0, (0.42, 0.55, 0.42), (0.58, 0.67, 0.58),
        fluid=[{"start": [0.1, 0.1, 0.1], "end": [0.9, 0.4, 0.9],
                "velocity": [0, 0, 0], "density": 1000.0,
                "color": [50, 100, 200], "spacing": "diameter"}],
        radius=0.033,
    )
    steps = 3
    sb, rb = solver_b.rollout_coupled(state0, rigid0, steps)

    solver_s = WCSPHRigid(
        scene,
        sweep_cfg=SweepConfig(impl="pallas", block_size=128, window_cap=512,
                              interpret=True,
                              pad_capacity=0),
    )
    state_s = solver_s.bind(tt.build_state(scene))
    rigid_s = solver_s.init_rigid(state_s)
    ss, rs = solver_s.rollout_coupled(state_s, rigid_s, steps)

    np.testing.assert_allclose(
        np.asarray(rs.com), np.asarray(rb.com), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(rs.v_com), np.asarray(rb.v_com), atol=1e-4
    )
    # particle-level check in a canonical (position-sorted) order
    def key(st):
        act = np.asarray(st.material) != -1
        x = np.asarray(st.x)[act]
        return x[np.lexsort((x[:, 2], x[:, 1], x[:, 0]))]

    np.testing.assert_allclose(key(jax.device_get(ss)),
                               key(jax.device_get(sb)), atol=1e-4)


def test_long_run_shape_preservation(tmp_path):
    """Tumbling-body soak (VERDICT r2 #6): 5k steps of fast free rotation
    must preserve every particle's distance to the COM.  The exact
    Rodrigues offset rotation keeps the drift at fp-rounding level; the
    pre-fix linearized update (x += dt (v_com + omega x r)) inflates
    |r| by theta^2/2 per step — ~4e-3 absolute over this soak, two
    orders of magnitude over the tolerance."""
    import dataclasses

    import jax.numpy as jnp

    from tisph.models.rigid import integrate_rigid

    from tisph.geometry.mesh import box_mesh, save_obj

    mesh_path = tmp_path / "box.obj"
    save_obj(box_mesh((0.45, 0.45, 0.45), (0.55, 0.55, 0.55)), mesh_path)
    raw = {
        "configuration": {
            "dim": 3,
            "domainStart": [0.0, 0.0, 0.0],
            "domainEnd": [1.0, 1.0, 1.0],
            "particleRadius": 0.025,
            "density0": 1000,
            "gravitation": [0.0, 0.0, 0.0],  # free tumble, no wall contact
            "c_s": 40.0,
        },
        "rigidBodies": [
            {"geometryFile": str(mesh_path), "scale": [1, 1, 1],
             "translation": [0, 0, 0], "rotationAngle": 0,
             "rotationAxis": [0, 1, 0], "velocity": [0, 0, 0],
             "density": 1000.0, "color": [150, 150, 150],
             "isDynamic": True}
        ],
        "fluidBlocks": [],
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(raw))
    scene = tt.load_scene(p)
    state = tt.build_state(scene)
    solver = WCSPHRigid(scene)
    state = solver.bind(state)
    rigid = solver.init_rigid(state)
    # fast tumble: |omega| ~ 21.5 rad/s, ~21 radians total over the soak
    rigid = dataclasses.replace(
        rigid, omega=jnp.asarray([[12.0, 16.0, 8.0]], jnp.float32)
    )
    params = solver.params

    host0 = jax.device_get(state)
    sel = (np.asarray(host0.object_id) == 0) & (
        np.asarray(host0.material) == MATERIAL_BOUNDARY
    )
    com0 = np.asarray(jax.device_get(rigid.com))[0]
    d0 = np.linalg.norm(np.asarray(host0.x)[sel] - com0, axis=1)

    zero = jnp.zeros_like(state.x)
    steps = 5000

    @jax.jit
    def soak(carry):
        def body(_, c):
            st, rg = c
            return integrate_rigid(st, rg, zero, params)

        return jax.lax.fori_loop(0, steps, body, carry)

    state2, rigid2 = soak((state, rigid))
    host2 = jax.device_get(state2)
    com2 = np.asarray(jax.device_get(rigid2.com))[0]
    # COM must not wander (no force, no gravity)
    assert np.abs(com2 - com0).max() < 1e-4
    # shape: per-particle COM distance preserved (no resort ran, so rows
    # align 1:1 with the initial state)
    d2 = np.linalg.norm(np.asarray(host2.x)[sel] - com2, axis=1)
    drift = np.abs(d2 - d0).max()
    assert drift < 1e-4, f"rigid shape drift {drift:.2e} over {steps} steps"
    # it actually rotated (a quarter-turn would already move corners far)
    moved = np.abs(np.asarray(host2.x)[sel] - np.asarray(host0.x)[sel]).max()
    assert moved > 0.01


def test_coupled_amortized_resort_tracks_r1(tmp_path):
    """rollout_coupled with resort_every=2: the seg structure rebuild is
    amortized across the R-group (one _seg_build per 2 substeps), and the
    trajectory stays within the stale-pair divergence bound of the R=1
    cadence over a short window (the same O((2 d_moved/h)^3) argument as
    the fluid path — WCSPHRigid._coupled_apply)."""
    import dataclasses

    from tisph.models.state import pad_state_capacity
    from tisph.ops.neighbors import SweepConfig

    scene, _, _, _ = _build(
        tmp_path, 400.0, (0.42, 0.55, 0.42), (0.58, 0.67, 0.58),
        fluid=[{"start": [0.1, 0.1, 0.1], "end": [0.9, 0.4, 0.9],
                "velocity": [0, 0, 0], "density": 1000.0,
                "color": [50, 100, 200], "spacing": "diameter"}],
        radius=0.033,
    )
    cfg = SweepConfig(impl="pallas", block_size=128, window_cap=512,
                      interpret=True,
                      pad_capacity=0)
    outs = {}
    for R in (1, 2):
        solver = WCSPHRigid(
            scene, sweep_cfg=dataclasses.replace(cfg, resort_every=R)
        )
        st = solver.bind(tt.build_state(scene))
        rg = solver.init_rigid(st)
        outs[R] = solver.rollout_coupled(st, rg, 6)
    s1, r1 = outs[1]
    s2, r2 = outs[2]
    h = 0.033 * 4.0  # support_length at this radius (kh = 4r default)
    np.testing.assert_allclose(np.asarray(r2.com), np.asarray(r1.com),
                               atol=0.05 * h)

    def key(st):
        act = np.asarray(st.material) != -1
        x = np.asarray(st.x)[act]
        return x[np.lexsort((x[:, 2], x[:, 1], x[:, 0]))]

    d = np.abs(key(jax.device_get(s2)) - key(jax.device_get(s1)))
    assert d.max() < 0.2 * h, d.max()
    assert np.isfinite(np.asarray(s2.x)).all()


def test_rigid_checkpoint_roundtrip(tmp_path):
    """RigidState rides the npz checkpoint (body momentum is NOT derivable
    from the particle snapshot: make_rigid_state zero-inits v_com/omega),
    and resuming reproduces the uninterrupted trajectory exactly."""
    from tisph import checkpoint

    scene, solver, state, rigid = _build(
        tmp_path, 400.0, (0.42, 0.55, 0.42), (0.58, 0.67, 0.58),
        fluid=[{"start": [0.1, 0.1, 0.1], "end": [0.9, 0.4, 0.9],
                "velocity": [0, 0, 0], "density": 1000.0,
                "color": [50, 100, 200], "spacing": "diameter"}],
        radius=0.04,
    )
    s1, r1 = solver.rollout_coupled(state, rigid, 3)
    p = tmp_path / "ck.npz"
    checkpoint.save_npz(s1, p, rigid=r1)
    s2, r2 = checkpoint.load_npz(p, with_rigid=True)
    assert r2 is not None
    np.testing.assert_array_equal(np.asarray(r2.v_com), np.asarray(r1.v_com))
    np.testing.assert_array_equal(np.asarray(r2.omega), np.asarray(r1.omega))
    # resumed run == uninterrupted run (bitwise on CPU)
    sa, ra = solver.rollout_coupled(s1, r1, 2)
    sb, rb = solver.rollout_coupled(s2, r2, 2)
    np.testing.assert_array_equal(np.asarray(sa.x), np.asarray(sb.x))
    np.testing.assert_array_equal(np.asarray(ra.com), np.asarray(rb.com))
    # plain state-only archives still load the old way
    checkpoint.save_npz(s1, tmp_path / "plain.npz")
    st = checkpoint.load_npz(tmp_path / "plain.npz")
    np.testing.assert_array_equal(np.asarray(st.x), np.asarray(s1.x))
    st2, rg2 = checkpoint.load_npz(tmp_path / "plain.npz", with_rigid=True)
    assert rg2 is None


def test_run_coupled_adaptive(tmp_path):
    """run_coupled: SolverBase.run's adaptive-recapacity loop over the
    (SimState, RigidState) carry — a deliberately small window cap must
    be detected and regrown mid-run, and the run completes healthy."""
    import dataclasses

    from tisph.ops.neighbors import SweepConfig

    scene, _, _, _ = _build(
        tmp_path, 400.0, (0.42, 0.55, 0.42), (0.58, 0.67, 0.58),
        fluid=[{"start": [0.1, 0.1, 0.1], "end": [0.9, 0.4, 0.9],
                "velocity": [0, 0, 0], "density": 1000.0,
                "color": [50, 100, 200], "spacing": "diameter"}],
        radius=0.04,
    )
    solver = WCSPHRigid(
        scene,
        sweep_cfg=SweepConfig(impl="pallas", block_size=128, window_cap=128,
                              interpret=True,
                              pad_capacity=0),
    )
    st = solver.bind(tt.build_state(scene))
    rg = solver.init_rigid(st)
    # force the cap BELOW the true need after bind's sizing so the
    # adaptive loop must detect and regrow it
    solver.sweep_cfg = dataclasses.replace(solver.sweep_cfg, window_cap=128)
    for name in [k for k in vars(solver) if k.endswith("_jit")]:
        setattr(solver, name, None)
    cap0 = solver.sweep_cfg.window_cap
    st, rg = solver.run_coupled(st, rg, 4, check_every=2)
    assert solver.sweep_cfg.window_cap > cap0  # regrew mid-run
    assert np.isfinite(np.asarray(st.x)).all()
    assert np.isfinite(np.asarray(rg.com)).all()


@pytest.mark.slow
@pytest.mark.parametrize("density,expect_above", [(200.0, True), (5000.0, False)])
def test_buoyancy_sharded(tmp_path, density, expect_above):
    """The buoyancy physics gates through the SHARDED coupled path
    (VERDICT r4 #3's done-criterion): ShardedWCSPH.rollout_coupled on a
    1-device mesh must reproduce the float/sink outcomes — on a GPU this
    runs the compiled kernels through the shard_map pipeline (halo
    extension, fused force_react, GSPMD-reduced body forces)."""
    from tisph.parallel import ShardedWCSPH, make_mesh

    scene, _, _, _ = _build(
        tmp_path, density, (0.42, 0.5, 0.42), (0.58, 0.62, 0.58),
        fluid=_POOL, radius=0.02,
    )
    mesh = make_mesh(1)
    solver = ShardedWCSPH(scene, mesh)
    state = solver.bind(tt.build_state(scene))
    rigid = solver.init_rigid(state)
    state, rigid = solver.run_coupled(state, rigid, 2000)
    r = jax.device_get(rigid)
    com_y = float(r.com[0, 1])
    if expect_above:
        assert com_y > 0.27, f"light body should float, com_y={com_y}"
    else:
        assert com_y < 0.27, f"heavy body should sink, com_y={com_y}"
    out = jax.device_get(state)
    act = np.asarray(out.material) != -1
    assert np.isfinite(np.asarray(out.x)[act]).all()
