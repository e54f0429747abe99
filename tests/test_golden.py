"""Golden-trajectory regression: recorded 2D and 3D dam-break trajectories
pin the physics across refactors (beyond the live fp64 oracle gate, this
catches unintended behavior drift in ANY component of the step).

The golden files are (re)generated with:
    python tests/test_golden.py --regenerate
"""

import os
import sys

import numpy as np
import jax
import pytest

import tisph as tt

HERE = os.path.dirname(__file__)

SCENE_2D = {
    "configuration": {
        "dim": 2,
        "domainStart": [0.0, 0.0],
        "domainEnd": [2.0, 1.0],
        "particleRadius": 0.02,
        "density0": 1000,
        "gravitation": [0.0, -9.81],
        "c_s": 50.0,
    },
    "boundaryBlocks": [
        {"start": [0.9, 0.08], "end": [1.1, 0.3]}
    ],
    "fluidBlocks": [
        {"start": [0.1, 0.1], "end": [0.5, 0.5], "velocity": [1.0, 0.0],
         "density": 1000.0, "color": [50, 100, 200]}
    ],
    "rigidBodies": [],
}

SCENE_3D = {
    "configuration": {
        "dim": 3,
        "domainStart": [0.0, 0.0, 0.0],
        "domainEnd": [1.6, 1.0, 1.0],
        "particleRadius": 0.025,
        "density0": 1000,
        "gravitation": [0.0, -9.81, 0.0],
        "c_s": 50.0,
    },
    "boundaryBlocks": [
        {"start": [0.7, 0.05, 0.3], "end": [0.9, 0.25, 0.7]}
    ],
    "fluidBlocks": [
        {"start": [0.08, 0.08, 0.08], "end": [0.45, 0.5, 0.5],
         "velocity": [1.0, 0.0, 0.0],
         "density": 1000.0, "color": [50, 100, 200]}
    ],
    "rigidBodies": [],
}

CASES = {
    "2d_dam_break": (SCENE_2D, 40),
    "3d_dam_break": (SCENE_3D, 30),
}


def _golden_path(name):
    return os.path.join(HERE, f"golden_{name}.npz")


def _run(scene_dict, steps):
    scene = tt.scene_from_dict(scene_dict)
    state = tt.build_state(scene)
    solver = tt.WCSPH(scene)
    state = solver.bind(state)
    state = solver.rollout(state, steps)
    out = jax.device_get(state)
    act = np.asarray(out.material) != -1
    order = np.lexsort(np.asarray(out.x)[act].T[::-1])
    return {
        "x": np.asarray(out.x)[act][order],
        "v": np.asarray(out.v)[act][order],
        "density": np.asarray(out.density)[act][order],
        "material": np.asarray(out.material)[act][order],
    }


@pytest.mark.parametrize("name", list(CASES))
def test_golden_trajectory(name):
    path = _golden_path(name)
    assert os.path.exists(path), f"golden file {path} missing — regenerate"
    got = _run(*CASES[name])
    with np.load(path) as z:
        np.testing.assert_array_equal(got["material"], z["material"])
        # fp32 noise across compilers/platforms; positions are the gate
        np.testing.assert_allclose(got["x"], z["x"], atol=5e-5)
        np.testing.assert_allclose(got["v"], z["v"], atol=5e-2)
        np.testing.assert_allclose(got["density"], z["density"], rtol=5e-4)


if __name__ == "__main__":
    if "--regenerate" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
        for name, (scene, steps) in CASES.items():
            np.savez_compressed(_golden_path(name), **_run(scene, steps))
            print(f"golden written: {_golden_path(name)}")
