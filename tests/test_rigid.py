"""End-to-end rigid-body scene: mesh file -> voxelized boundary particles ->
fluid impacting the obstacle (reference main_3d path with rigidBodies)."""

import json
import os

import numpy as np
import jax
import pytest

import tisph as tt
from tisph.models.state import MATERIAL_BOUNDARY

SCENES = os.path.join(os.path.dirname(__file__), "..", "scenes")


def test_rigid_body_scene_end_to_end(tmp_path):
    raw = {
        "configuration": {
            "dim": 3,
            "domainStart": [0.0, 0.0, 0.0],
            "domainEnd": [2.0, 1.0, 1.0],
            "particleRadius": 0.025,
            "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0],
            "c_s": 50.0,
        },
        "rigidBodies": [
            {"geometryFile": os.path.join(SCENES, "assets", "sphere.obj"),
             "scale": [0.15, 0.15, 0.15], "translation": [1.0, 0.25, 0.5],
             "rotationAngle": 30, "rotationAxis": [0, 1, 0],
             "velocity": [0, 0, 0], "density": 1000.0,
             "color": [150, 150, 150]}
        ],
        "fluidBlocks": [
            {"start": [0.1, 0.1, 0.3], "end": [0.5, 0.5, 0.7],
             "velocity": [2.0, 0.0, 0.0], "density": 1000.0,
             "color": [50, 100, 200]}
        ],
    }
    p = tmp_path / "rigid.json"
    p.write_text(json.dumps(raw))
    scene = tt.load_scene(p)
    state = tt.build_state(scene)
    solver = tt.WCSPH(scene)
    state = solver.bind(state)

    host0 = jax.device_get(state)
    mat0 = np.asarray(host0.material)
    nb = (mat0 == MATERIAL_BOUNDARY).sum()
    assert nb > 100, "sphere voxelization produced too few boundary particles"
    # Akinci volumes were precomputed at bind for the boundary set
    volb = np.asarray(host0.volume)[mat0 == MATERIAL_BOUNDARY]
    assert (volb != scene.particle_volume0).any()

    state = solver.rollout(state, 40)
    out = jax.device_get(state)
    mat = np.asarray(out.material)
    x = np.asarray(out.x)
    act = mat != -1
    assert np.isfinite(x[act]).all()
    # boundary (sphere) must not have moved: same position multiset
    b0 = np.asarray(host0.x)[mat0 == MATERIAL_BOUNDARY]
    b1 = x[mat == MATERIAL_BOUNDARY]
    np.testing.assert_allclose(
        b0[np.lexsort(b0.T)], b1[np.lexsort(b1.T)], atol=1e-6
    )
    # fluid moved toward the obstacle
    f0 = np.asarray(host0.x)[mat0 == 1]
    f1 = x[mat == 1]
    assert f1[:, 0].mean() > f0[:, 0].mean()
