"""3-axis (x × y × z) box decomposition (parallel/domain2d.py::
ShardedWCSPHRect) on the 8-device CPU mesh: per-axis buffered migration +
3-stage corner-covering halo exchange (last axis first — double-corner
cells ride z THEN y THEN x) must reproduce the single-chip trajectory.
The 2x2x2 mesh cuts ALL THREE grid axes, so every corner/edge/face class
of the box halo is live in these gates."""

import numpy as np
import jax
import pytest

import tisph as tt
from tisph.ops.neighbors import SweepConfig
from tisph.parallel import ShardedWCSPHRect, make_mesh3d

from test_parallel2d import _scene, _canon, _single_chip, _CFG


def test_3d_box_matches_single_chip():
    scene = _scene()
    steps = 5
    x1, r1, v1 = _canon(_single_chip(scene, steps))

    mesh = make_mesh3d(2, 2, 2)
    s3 = ShardedWCSPHRect(scene, mesh, sweep_cfg=SweepConfig(**_CFG))
    st3 = s3.bind(tt.build_state(scene))
    for _ in range(steps):
        st3 = s3.step(st3)
    o3 = jax.device_get(st3)
    x3, r3, v3 = _canon(o3)

    assert len(x1) == len(x3)
    assert np.abs(x1 - x3).max() < 1e-5, (
        f"3-axis box position divergence {np.abs(x1 - x3).max():.2e}"
    )
    np.testing.assert_allclose(v1, v3, atol=5e-3)
    np.testing.assert_allclose(r1, r3, rtol=1e-4)
    m = jax.device_get(s3.metrics(st3))
    assert int(m["nan_count"]) == 0
    assert int(m["occ_halo"]) == 0, "halo buffer overflowed silently"
    assert int(m["migrate_anomalies"]) == 0


def test_3d_box_amortized_rollout_matches_single_chip():
    """resort_every=2 over the 2x2x2 mesh: cached merge permutation +
    6-ppermute value refresh per substep must reproduce the single-chip
    amortized trajectory."""
    scene = _scene()
    cfg = dict(_CFG, resort_every=2)
    s1 = tt.WCSPH(scene, sweep_cfg=SweepConfig(**cfg))
    st1 = s1.bind(tt.build_state(scene))
    st1 = s1.rollout(st1, 6)
    x1, r1, _ = _canon(jax.device_get(st1))

    mesh = make_mesh3d(2, 2, 2)
    s3 = ShardedWCSPHRect(scene, mesh, sweep_cfg=SweepConfig(**cfg))
    st3 = s3.bind(tt.build_state(scene))
    st3 = s3.rollout(st3, 6)
    x3, r3, _ = _canon(jax.device_get(st3))

    assert np.abs(x1 - x3).max() < 1e-5
    np.testing.assert_allclose(r1, r3, rtol=1e-4)


def test_3d_box_emitter_matches_single_chip():
    """Per-shard tail emission on the 2x2x2 box mesh: the same owner-shard
    placement logic as the 2-axis gate, but now the ownership test spans
    all three cut tables (_tbl_sx/_tbl_sy/_tbl_sz) — the emitter rectangle
    straddles the x and z cuts, so seeds land in four different boxes.
    Must reproduce the single-chip rollout_emit trajectory (6-step horizon:
    the cross-decomposition comparison bound measured in test_parallel2d)."""
    from tisph.geometry.emitter import make_emitter_state

    from test_parallel2d import _canon as _canon2, _emitter_scene

    scene = _emitter_scene()
    cfg = dict(_CFG, resort_every=2)

    s1 = tt.WCSPH(scene, sweep_cfg=SweepConfig(**cfg))
    st1 = s1.bind(tt.build_state(scene, extra_capacity=512))
    es1 = make_emitter_state(scene.emitters[0], scene)
    st1, ems1 = s1.rollout_emit(st1, [es1], 6)
    x1, r1, v1 = _canon2(jax.device_get(st1))

    mesh = make_mesh3d(2, 2, 2)
    s3 = ShardedWCSPHRect(scene, mesh, sweep_cfg=SweepConfig(**cfg))
    st3 = s3.bind(tt.build_state(scene, extra_capacity=512))
    es3 = make_emitter_state(scene.emitters[0], scene)
    st3, ems3 = s3.rollout_emit(st3, [es3], 6)
    x3, r3, v3 = _canon2(jax.device_get(st3))

    assert int(jax.device_get(ems1[0].emitted)) == int(
        jax.device_get(ems3[0].emitted)
    )
    assert len(x1) == len(x3)
    assert np.abs(x1 - x3).max() < 1e-5, (
        f"3-axis emitter position divergence {np.abs(x1 - x3).max():.2e}"
    )
    np.testing.assert_allclose(v1, v3, atol=5e-3)
    np.testing.assert_allclose(r1, r3, rtol=1e-4)
    m = jax.device_get(s3.metrics(st3))
    assert int(m["nan_count"]) == 0
    assert int(m["migrate_anomalies"]) == 0


def test_3d_box_rigid_coupled_matches_single_chip(tmp_path):
    """Dynamic rigid bodies compose with the 3-axis box mesh: the coupled
    rollout (per-substep bvol + density + fused force_react exchanges over
    the 3-stage halo, GSPMD-reduced body forces) must reproduce the
    single-chip WCSPHRigid trajectory.  The floating box straddles all
    three cuts of the 2x2x2 mesh, so its boundary rows live in every
    shard and the psum body-force reduction is genuinely 8-way.  Fluid
    positions compare as SETS (Hausdorff) — the test_parallel2d coupled
    gate's pairing argument."""
    import json

    from tisph.geometry.mesh import box_mesh, save_obj
    from tisph.models.wcsph_rigid import WCSPHRigid

    mesh_path = tmp_path / "box.obj"
    save_obj(box_mesh((0.4, 0.55, 0.4), (0.6, 0.7, 0.6)), mesh_path)
    raw = {
        "configuration": {
            "dim": 3, "domainStart": [0, 0, 0], "domainEnd": [1, 1, 1],
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0, -9.81, 0], "c_s": 40.0,
        },
        "rigidBodies": [
            {"geometryFile": str(mesh_path), "scale": [1, 1, 1],
             "translation": [0, 0, 0], "rotationAngle": 0,
             "rotationAxis": [0, 1, 0], "velocity": [0, 0, 0],
             "density": 300.0, "color": [150, 150, 150], "isDynamic": True}
        ],
        "fluidBlocks": [
            {"start": [0.1, 0.1, 0.1], "end": [0.9, 0.45, 0.9],
             "velocity": [0, 0, 0], "density": 1000.0,
             "color": [50, 100, 200]}
        ],
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(raw))
    scene = tt.load_scene(p)

    s1 = WCSPHRigid(scene, sweep_cfg=SweepConfig(**_CFG))
    st1 = s1.bind(tt.build_state(scene))
    rg1 = s1.init_rigid(st1)
    st1, rg1 = s1.rollout_coupled(st1, rg1, 3)
    o1, r1 = jax.device_get(st1), jax.device_get(rg1)

    mesh = make_mesh3d(2, 2, 2)
    s3 = ShardedWCSPHRect(scene, mesh, sweep_cfg=SweepConfig(**_CFG))
    assert s3.boundary_mode == "per_step"
    st3 = s3.bind(tt.build_state(scene))
    rg3 = s3.init_rigid(st3)
    st3, rg3 = s3.rollout_coupled(st3, rg3, 3)
    o3, r3 = jax.device_get(st3), jax.device_get(rg3)

    a1 = np.asarray(o1.material) != -1
    a3 = np.asarray(o3.material) != -1
    assert a1.sum() == a3.sum()
    x1 = np.asarray(o1.x)[a1]
    x3 = np.asarray(o3.x)[a3]
    d = np.linalg.norm(x1[:, None, :] - x3[None, :, :], axis=-1)
    hd = max(d.min(axis=1).max(), d.min(axis=0).max())
    assert hd < 1e-5, f"coupled 3-axis set divergence {hd:.2e}"
    np.testing.assert_allclose(np.asarray(r1.com), np.asarray(r3.com),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(r1.v_com), np.asarray(r3.v_com),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(r1.omega), np.asarray(r3.omega),
                               atol=1e-4)


def test_3d_box_rejects_bad_meshes():
    scene2d = tt.scene_from_dict(
        {
            "configuration": {
                "dim": 2,
                "domainStart": [0.0, 0.0],
                "domainEnd": [1.0, 1.0],
                "particleRadius": 0.01,
                "density0": 1000,
                "gravitation": [0.0, -9.81],
                "c_s": 50.0,
            },
            "fluidBlocks": [
                {"start": [0.1, 0.1], "end": [0.4, 0.4],
                 "velocity": [0.0, 0.0], "density": 1000.0,
                 "color": [50, 100, 200]}
            ],
            "rigidBodies": [],
        }
    )
    with pytest.raises(ValueError, match="dim"):
        ShardedWCSPHRect(scene2d, make_mesh3d(2, 2, 2))
