"""Multi-chip tests on the 8-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8; SURVEY.md §4e): the sharded step
(distributed sort + ppermute halo exchange + blocked sweeps) must reproduce
the single-device trajectory."""

import numpy as np
import jax
import pytest

import tisph as tt
from tisph.parallel import ShardedWCSPH, make_mesh


def _scene(radius=0.02):
    return tt.scene_from_dict(
        {
            "configuration": {
                "dim": 3,
                "domainStart": [0.0, 0.0, 0.0],
                "domainEnd": [1.0, 1.0, 1.0],
                "particleRadius": radius,
                "density0": 1000,
                "gravitation": [0.0, -9.81, 0.0],
                "c_s": 50.0,
            },
            "fluidBlocks": [
                {"start": [0.15, 0.15, 0.15], "end": [0.55, 0.55, 0.55],
                 "velocity": [0.2, -1.0, 0.5], "density": 1000.0,
                 "color": [50, 100, 200]}
            ],
            "rigidBodies": [],
        }
    )


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_matches_single_device(n_devices):
    assert len(jax.devices()) >= n_devices
    scene = _scene()
    steps = 5

    # single device
    state1 = tt.build_state(scene)
    solver1 = tt.WCSPH(scene)
    state1 = solver1.bind(state1)
    for _ in range(steps):
        state1 = solver1.step(state1)
    out1 = jax.device_get(state1)

    # sharded
    state2 = tt.build_state(scene)
    mesh = make_mesh(n_devices)
    solver2 = ShardedWCSPH(scene, mesh)
    state2 = solver2.bind(state2)
    for _ in range(steps):
        state2 = solver2.step(state2)
    out2 = jax.device_get(state2)

    n = int(out1.num_active)
    a1 = np.asarray(out1.material) != -1
    a2 = np.asarray(out2.material) != -1
    assert a1.sum() == n and a2.sum() == n

    # Both paths keep the state cell-sorted with a STABLE sort starting
    # from the same initial order, so active rows align 1:1 (the sharded
    # capacity padding only appends inactive sentinel rows at the tail).
    x1, v1, r1 = np.asarray(out1.x)[a1], np.asarray(out1.v)[a1], np.asarray(out1.density)[a1]
    x2, v2, r2 = np.asarray(out2.x)[a2], np.asarray(out2.v)[a2], np.asarray(out2.density)[a2]
    assert np.abs(x1 - x2).max() < 1e-5, f"position divergence {np.abs(x1 - x2).max():.2e}"
    np.testing.assert_allclose(v1, v2, atol=5e-3)
    np.testing.assert_allclose(r1, r2, rtol=1e-4)


def test_sharded_pallas_matches_blocked():
    """The pallas-in-shard_map path (interpret mode on the CPU mesh) must
    reproduce the blocked-sharded trajectory."""
    from tisph.ops.neighbors import SweepConfig

    scene = _scene(radius=0.04)
    mesh = make_mesh(4)
    s_b = ShardedWCSPH(
        scene, mesh,
        sweep_cfg=SweepConfig(impl="blocked", block_size=128, window_cap=1024),
    )
    st_b = s_b.bind(tt.build_state(scene))
    s_p = ShardedWCSPH(
        scene, mesh,
        sweep_cfg=SweepConfig(impl="pallas", block_size=128, window_cap=1152,
                              interpret=True),
    )
    st_p = s_p.bind(tt.build_state(scene))
    for _ in range(3):
        st_b = s_b.step(st_b)
        st_p = s_p.step(st_p)
    ob, op = jax.device_get(st_b), jax.device_get(st_p)
    assert (np.asarray(ob.material) == np.asarray(op.material)).all()
    f = np.asarray(ob.material) == 1
    assert np.abs(np.asarray(ob.x) - np.asarray(op.x))[f].max() < 1e-5


def test_sharded_metrics_finite():
    scene = _scene()
    state = tt.build_state(scene)
    mesh = make_mesh(4)
    solver = ShardedWCSPH(scene, mesh)
    state = solver.bind(state)
    state = solver.step(state)
    m = jax.device_get(solver.metrics(state))
    assert float(m["nan_count"]) == 0
    assert np.isfinite(float(m["avg_density_error"]))


def test_sharded_emitter_composes():
    """maybe_emit is a pure scatter on the pytree, so it composes with the
    sharded step (tail pool slots live on the last shard after the sort)."""
    from tisph.geometry.emitter import make_emitter_state, maybe_emit

    scene = tt.scene_from_dict(
        {
            "configuration": {
                "dim": 3, "domainStart": [0, 0, 0], "domainEnd": [1, 1, 1],
                "particleRadius": 0.04, "density0": 1000,
                "gravitation": [0, -9.81, 0], "c_s": 50.0,
            },
            "fluidBlocks": [
                {"start": [0.15, 0.15, 0.15], "end": [0.5, 0.4, 0.5],
                 "velocity": [0, 0, 0], "density": 1000.0, "color": [50, 100, 200]}
            ],
            "emitters": [
                {"start": [0.5, 0.8, 0.5], "end": [0.62, 0.8001, 0.62],
                 "velocity": [0, -1.0, 0], "interval": 5, "maxParticles": 64}
            ],
            "rigidBodies": [],
        }
    )
    state = tt.build_state(scene, extra_capacity=256)
    mesh = make_mesh(4)
    solver = ShardedWCSPH(scene, mesh)
    state = solver.bind(state)
    es = make_emitter_state(scene.emitters[0], scene)
    emit = jax.jit(lambda s, e: maybe_emit(s, e, scene.particle_volume0))
    n0 = int(jax.device_get(state.num_active))
    for _ in range(12):
        state, es = emit(state, es)
        state = solver.step(state)
    out = jax.device_get(state)
    assert int(es.emitted) == 3 * es.batch_size  # steps 0, 5, 10
    assert int(out.num_active) == n0 + int(es.emitted)
    act = np.asarray(out.material) != -1
    assert act.sum() == int(out.num_active)
    assert np.isfinite(np.asarray(out.x)[act]).all()


def test_graft_entry():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out.x)
    g.dryrun_multichip(8)


def test_halo_overflow_detected_and_regrown():
    """Dam-break-style compaction: fluid drops into the low-x corner, so a
    shard boundary ends up cutting through a dense slab and the stencil
    reach exceeds the bind-time halo.  The per-dispatch occ_halo flag must
    trip, run() must deepen the halo, and the post-regrow trajectory must
    match the single-device solver."""
    import dataclasses
    import jax.numpy as jnp

    scene = tt.scene_from_dict(
        {
            "configuration": {
                "dim": 3,
                "domainStart": [0.0, 0.0, 0.0],
                "domainEnd": [2.0, 1.0, 1.0],
                "particleRadius": 0.03,
                "density0": 1000,
                "gravitation": [-6.0, -9.81, 0.0],  # drive fluid into low-x
                "c_s": 50.0,
            },
            "fluidBlocks": [
                # thin sheet spread across x: migrates into few slabs
                {"start": [0.1, 0.55, 0.3], "end": [1.9, 0.75, 0.7],
                 "velocity": [-2.0, -1.0, 0.0], "density": 1000.0,
                 "color": [50, 100, 200]}
            ],
            "rigidBodies": [],
        }
    )
    mesh = make_mesh(8)

    # deliberately-undersized halo so migration overflows it quickly
    solver = ShardedWCSPH(scene, mesh, halo=128)
    state = solver.bind(tt.build_state(scene))
    state = solver.rollout(state, 25)
    assert int(jax.device_get(state.occ_halo)) == 1, "halo overflow undetected"

    # run() must auto-deepen and keep going
    solver2 = ShardedWCSPH(scene, mesh, halo=128)
    state2 = solver2.bind(tt.build_state(scene))
    h0 = solver2.halo
    state2 = solver2.run(state2, 30, check_every=5)
    assert solver2.halo > h0, "run() did not deepen the halo"
    assert int(jax.device_get(state2.occ_halo)) == 0  # reset after checks

    # after the regrow, further sharded steps agree with single-device
    ref = tt.WCSPH(scene, sweep_cfg=solver2.sweep_cfg)
    sref = ref.bind(tt.build_state(scene))
    sref = ref.rollout(sref, 30)
    sref = ref.rollout(sref, 5)
    state2 = solver2.rollout(state2, 5)
    o1, o2 = jax.device_get(sref), jax.device_get(state2)
    a1 = np.asarray(o1.material) != -1
    a2 = np.asarray(o2.material) != -1

    def key(x, m):
        x = np.asarray(x)[m]
        return x[np.lexsort((x[:, 2], x[:, 1], x[:, 0]))]

    # trajectories diverge while the halo was truncated; compare bulk stats
    # instead of per-particle: the fluid must stay finite and in-domain,
    # and the two particle sets must occupy the same region
    assert np.isfinite(np.asarray(o2.x)[a2]).all()
    np.testing.assert_allclose(
        key(o1.x, a1).mean(axis=0), key(o2.x, a2).mean(axis=0), atol=0.05
    )


def test_sharded_seg_matches_blocked():
    """The seg layout inside shard_map (the flagship single-chip kernels,
    per shard, windows over the halo-extended array) must reproduce the
    blocked-sharded trajectory."""
    from tisph.ops.neighbors import SweepConfig

    scene = _scene(radius=0.04)
    mesh = make_mesh(4)
    s_b = ShardedWCSPH(
        scene, mesh,
        sweep_cfg=SweepConfig(impl="blocked", block_size=128, window_cap=1024),
    )
    st_b = s_b.bind(tt.build_state(scene))
    s_p = ShardedWCSPH(
        scene, mesh,
        sweep_cfg=SweepConfig(impl="pallas", block_size=128, window_cap=1152,
                              interpret=True),
    )
    st_p = s_p.bind(tt.build_state(scene))
    assert s_p.sweep_cfg.pad_capacity > 0  # bind sized the per-shard pad
    for _ in range(3):
        st_b = s_b.step(st_b)
        st_p = s_p.step(st_p)
    ob, op = jax.device_get(st_b), jax.device_get(st_p)
    assert (np.asarray(ob.material) == np.asarray(op.material)).all()
    f = np.asarray(ob.material) == 1
    assert np.abs(np.asarray(ob.x) - np.asarray(op.x))[f].max() < 1e-5
    assert int(op.occ_rowpad) > 0  # the pad diagnostic is live


def test_sharded_seg_amortized_matches_single_chip():
    """resort_every=2 on the sharded seg path (VERDICT r2 #5): the
    build/apply split must reproduce the single-chip amortized trajectory
    — both sides rebuild on the same cadence, so the paths are
    algorithmically identical up to the halo extension."""
    import tisph.models.wcsph as _w
    from tisph.ops.neighbors import SweepConfig

    scene = _scene(radius=0.04)
    cfg = dict(impl="pallas", block_size=128, window_cap=1152,
               interpret=True, resort_every=2)

    s1 = tt.WCSPH(scene, sweep_cfg=SweepConfig(**cfg))
    st1 = s1.bind(tt.build_state(scene))
    st1 = s1.rollout(st1, 4)

    mesh = make_mesh(4)
    s2 = ShardedWCSPH(scene, mesh, sweep_cfg=SweepConfig(**cfg))
    st2 = s2.bind(tt.build_state(scene))
    st2 = s2.rollout(st2, 4)

    o1, o2 = jax.device_get(st1), jax.device_get(st2)
    a1 = np.asarray(o1.material) != -1
    a2 = np.asarray(o2.material) != -1
    assert a1.sum() == a2.sum()
    x1, x2 = np.asarray(o1.x)[a1], np.asarray(o2.x)[a2]
    assert np.abs(x1 - x2).max() < 1e-5, (
        f"amortized sharded divergence {np.abs(x1 - x2).max():.2e}"
    )
    np.testing.assert_allclose(
        np.asarray(o1.density)[a1], np.asarray(o2.density)[a2], rtol=1e-4
    )
    # occupancy metrics are surfaced (VERDICT r2 weak #8)
    m = jax.device_get(s2.metrics(st2))
    assert int(m["run_cap"]) == s2.sweep_cfg.window_cap
    assert int(m["max_run_length"]) > 0
    assert int(m["seg_pad_cap"]) == s2.sweep_cfg.pad_capacity
    assert int(m["halo_depth"]) == s2.halo


# ---------------------------------------------------------------------------
# edge-exchange resort (parallel/domain.py::_exchange_resort): must be
# BITWISE equal to the stock distributed stable sort — directly when the
# rank-shift bound holds, via the guarded fallback otherwise
# ---------------------------------------------------------------------------

def test_exchange_resort_matches_global_bitwise():
    import dataclasses

    scene = _scene()
    mesh = make_mesh(4)
    outs = {}
    for mode in ("global", "exchange"):
        state = tt.build_state(scene)
        solver = ShardedWCSPH(scene, mesh, resort=mode)
        state = solver.bind(state)
        for _ in range(6):
            state = solver.step(state)
        outs[mode] = jax.device_get(state)
    for f in ("x", "v", "density", "pressure", "material", "object_id"):
        np.testing.assert_array_equal(
            np.asarray(getattr(outs["global"], f)),
            np.asarray(getattr(outs["exchange"], f)),
            err_msg=f"exchange resort diverged from the stock sort on {f}",
        )


def test_exchange_resort_rides_edges_in_steady_state():
    """The exchange path must actually be TAKEN once the array is sorted
    (perpetual fallback would silently pay stock-sort prices — the metric
    the 1e9 bridge's scaling claim rests on)."""
    import dataclasses
    import jax.numpy as jnp

    scene = _scene()
    mesh = make_mesh(4)
    state = tt.build_state(scene)
    # default edge = halo depth: scales with the per-x-column particle
    # count, which is also the rank-shift scale (a particle crossing one
    # x-cell boundary re-ranks past ~one x-column; measured ~1300 rows per
    # step in this scene, so a shallow forced edge WOULD legitimately trip)
    solver = ShardedWCSPH(scene, mesh, resort="exchange")
    state = solver.bind(state)
    state = solver.step(state)  # first rebuild may fall back (lattice order)
    state = dataclasses.replace(state, occ_resort=jnp.zeros((), jnp.int32))
    for _ in range(5):
        state = solver.step(state)
    assert int(jax.device_get(state.occ_resort)) == 0


def test_exchange_resort_guard_catches_shuffle():
    """A globally shuffled state (arbitrary rank shifts, far beyond any edge
    depth) must trip the seam guard, count in occ_resort, and still produce
    the exact stock-sort trajectory through the fallback."""
    import dataclasses
    import jax.numpy as jnp

    scene = _scene()
    mesh = make_mesh(4)

    def run(mode):
        state = tt.build_state(scene)
        solver = ShardedWCSPH(scene, mesh, resort=mode, resort_edge=128)
        state = solver.bind(state)
        state = solver.step(state)  # settle into sorted order
        rng = np.random.default_rng(7)
        perm = jnp.asarray(rng.permutation(state.capacity))
        state = jax.tree.map(
            lambda a: a[perm] if getattr(a, "ndim", 0) >= 1 else a, state
        )
        state = dataclasses.replace(state, occ_resort=jnp.zeros((), jnp.int32))
        state = solver.shard_state(state)
        state = solver.step(state)
        return jax.device_get(state)

    out_g = run("global")
    out_e = run("exchange")
    assert int(out_e.occ_resort) >= 1, "seam guard did not trip on a shuffle"
    for f in ("x", "v", "density", "material"):
        np.testing.assert_array_equal(
            np.asarray(getattr(out_g, f)), np.asarray(getattr(out_e, f)),
            err_msg=f"fallback path diverged from the stock sort on {f}",
        )


def test_exchange_resort_run_deepens_edge():
    """run() must deepen the edge when the guard trips persistently."""
    scene = _scene()
    mesh = make_mesh(4)
    state = tt.build_state(scene)
    solver = ShardedWCSPH(scene, mesh, resort="exchange", resort_edge=128)
    state = solver.bind(state)
    # force-mark persistent trips and let run()'s adaptive check react
    import dataclasses
    import jax.numpy as jnp

    state = solver.step(state)
    state = dataclasses.replace(
        state, occ_resort=jnp.asarray(10, jnp.int32)
    )
    old = solver.resort_edge
    state = solver.run(state, 1)
    assert solver.resort_edge > old


def _rigid_scene(tmp_path, body_density=300.0, radius=0.04):
    import json

    from tisph.geometry.mesh import box_mesh, save_obj

    mesh_path = tmp_path / "box.obj"
    save_obj(box_mesh((0.4, 0.55, 0.4), (0.6, 0.7, 0.6)), mesh_path)
    raw = {
        "configuration": {
            "dim": 3, "domainStart": [0, 0, 0], "domainEnd": [1, 1, 1],
            "particleRadius": radius, "density0": 1000,
            "gravitation": [0, -9.81, 0], "c_s": 40.0,
        },
        "rigidBodies": [
            {"geometryFile": str(mesh_path), "scale": [1, 1, 1],
             "translation": [0, 0, 0], "rotationAngle": 0,
             "rotationAxis": [0, 1, 0], "velocity": [0, 0, 0],
             "density": body_density, "color": [150, 150, 150],
             "isDynamic": True}
        ],
        "fluidBlocks": [
            {"start": [0.1, 0.1, 0.1], "end": [0.9, 0.45, 0.9],
             "velocity": [0, 0, 0], "density": 1000.0,
             "color": [50, 100, 200]}
        ],
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(raw))
    return tt.load_scene(p)


@pytest.mark.parametrize("resort_every", [1, 2])
def test_sharded_rigid_coupled_matches_single_chip(tmp_path, resort_every):
    """Sharded two-way rigid coupling (VERDICT r4 #3): the 4-device
    rollout_coupled — per-substep bvol + density + fused force_react
    sweeps over the halo-extended shards, per-body reductions on the
    sharded arrays (GSPMD inserts the cross-shard all-reduces) — must
    reproduce the single-chip WCSPHRigid trajectory AND rigid state."""
    from tisph.models.wcsph_rigid import WCSPHRigid
    from tisph.ops.neighbors import SweepConfig

    scene = _rigid_scene(tmp_path)
    cfg = dict(impl="pallas", block_size=128, window_cap=1152,
               interpret=True, resort_every=resort_every)
    steps = 3 if resort_every == 1 else 4

    s1 = WCSPHRigid(scene, sweep_cfg=SweepConfig(**cfg))
    st1 = s1.bind(tt.build_state(scene))
    rg1 = s1.init_rigid(st1)
    st1, rg1 = s1.rollout_coupled(st1, rg1, steps)
    o1, r1 = jax.device_get(st1), jax.device_get(rg1)

    mesh = make_mesh(4)
    s2 = ShardedWCSPH(scene, mesh, sweep_cfg=SweepConfig(**cfg))
    assert s2.boundary_mode == "per_step"  # auto-selected for rigid scenes
    st2 = s2.bind(tt.build_state(scene))
    rg2 = s2.init_rigid(st2)
    st2, rg2 = s2.rollout_coupled(st2, rg2, steps)
    o2, r2 = jax.device_get(st2), jax.device_get(rg2)

    a1 = np.asarray(o1.material) != -1
    a2 = np.asarray(o2.material) != -1
    assert a1.sum() == a2.sum()
    assert np.abs(np.asarray(o1.x)[a1] - np.asarray(o2.x)[a2]).max() < 1e-5
    np.testing.assert_allclose(
        np.asarray(o1.density)[a1], np.asarray(o2.density)[a2], rtol=1e-4
    )
    np.testing.assert_allclose(np.asarray(r1.com), np.asarray(r2.com),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(r1.v_com), np.asarray(r2.v_com),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(r1.omega), np.asarray(r2.omega),
                               atol=1e-4)


@pytest.mark.parametrize("mesh_kind", ["slab", "rect"])
def test_sharded_plain_step_recomputes_boundary_volumes(tmp_path, mesh_kind):
    """A PLAIN (non-coupled) sharded step on a dynamic-rigid scene must
    recompute the Akinci boundary volumes every substep, exactly like the
    single-chip per_step path (models/wcsph.py::_seg_apply_pack): bind
    skips the static precompute under boundary_mode='per_step' (which is
    auto-selected for rigid scenes), so a missing bvol sweep would freeze
    boundary rows at build_state's uniform volume0 — a silent physics
    divergence the round-5 review caught in both sharded classes."""
    from tisph.ops.neighbors import SweepConfig
    from tisph.parallel import ShardedWCSPHRect, make_mesh2d

    scene = _rigid_scene(tmp_path)
    cfg = dict(impl="pallas", block_size=128, window_cap=1152, interpret=True)
    steps = 3

    s1 = tt.WCSPH(scene, sweep_cfg=SweepConfig(**cfg),
                  boundary_mode="per_step")
    st1 = s1.bind(tt.build_state(scene))
    for _ in range(steps):
        st1 = s1.step(st1)
    o1 = jax.device_get(st1)

    if mesh_kind == "slab":
        s2 = ShardedWCSPH(scene, make_mesh(4), sweep_cfg=SweepConfig(**cfg))
    else:
        s2 = ShardedWCSPHRect(scene, make_mesh2d(2, 2),
                              sweep_cfg=SweepConfig(**cfg))
    assert s2.boundary_mode == "per_step"  # auto-selected for rigid scenes
    st2 = s2.bind(tt.build_state(scene))
    for _ in range(steps):
        st2 = s2.step(st2)
    o2 = jax.device_get(st2)

    a1 = np.asarray(o1.material) != -1
    a2 = np.asarray(o2.material) != -1
    assert a1.sum() == a2.sum()

    # the bvol sweep actually ran: boundary rows moved off the uniform
    # volume0 fill that build_state writes
    bd2 = np.asarray(o2.material) == 0
    vol0 = float(np.asarray(o2.volume)[a2 & ~bd2].max())
    dev = np.abs(np.asarray(o2.volume)[bd2] - vol0)
    assert bd2.sum() > 0 and dev.max() > 0.1 * vol0

    # and it matches the single-chip per_step trajectory.  Boundary rows
    # never move, so a canonical position sort pairs them exactly — their
    # Akinci volumes are THE per_step output under test; fluid positions
    # compare as sets (Hausdorff) because the dam's initial shock makes
    # near-coincident rows that mispair under any per-row ordering at f32
    # noise (the test_parallel2d.py coupled-gate precedent)
    def canon_boundary(o):
        bd = np.asarray(o.material) == 0
        x = np.asarray(o.x)[bd]
        xr = np.round(x / 0.002).astype(np.int64)
        k = np.lexsort((xr[:, 2], xr[:, 1], xr[:, 0]))
        return x[k], np.asarray(o.volume)[bd][k]

    bx1, bv1 = canon_boundary(o1)
    bx2, bv2 = canon_boundary(o2)
    assert np.abs(bx1 - bx2).max() == 0.0
    np.testing.assert_allclose(bv1, bv2, rtol=1e-5)

    f1 = np.asarray(o1.x)[np.asarray(o1.material) == 1]
    f2 = np.asarray(o2.x)[np.asarray(o2.material) == 1]
    d = np.linalg.norm(f1[:, None, :] - f2[None, :, :], axis=-1)
    hd = max(d.min(axis=1).max(), d.min(axis=0).max())
    assert hd < 1e-5, f"plain per_step set divergence {hd:.2e}"
