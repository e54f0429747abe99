"""Scene-config schema tests: parse the reference's exact JSON schema
(SURVEY.md §2.2), including keys the reference ignores."""

import json

import numpy as np
import pytest

import tisph as tt
from tisph.config import SolverParams


REFERENCE_STYLE_3D = {
    "configuration": {
        "dim": 3,
        "domainStart": [0.0, 0.0, 0.0],
        "domainEnd": [5.0, 3.0, 2.0],
        "particleRadius": 0.01,
        "numberOfStepsPerRenderUpdate": 1,
        "density0": 1000,
        "simulationMethod": 0,
        "gravitation": [0.0, -9.81, 0.0],
        "outputInterval": 40,
        "B": 50000,
        "gamma": 7,
        "dt": 4e-4,
        "collisionFactor": 0.5,
        "viscosity": 0.01,
        "surfaceTension": 0.01,
        "c_s": 88.5,
    },
    "rigidBodies": [],
    "fluidBlocks": [
        {
            "objectId": 0,
            "start": [0.3, 0.1, 0.7],
            "end": [1.0, 1.0, 1.0],
            "translation": [0.0, 0.0, 0.0],
            "scale": [1, 1, 1],
            "velocity": [0.0, -1.0, 10.0],
            "density": 1000.0,
            "color": [50, 100, 200],
        }
    ],
}


def test_parse_reference_schema():
    scene = tt.scene_from_dict(REFERENCE_STYLE_3D)
    assert scene.dim == 3
    assert scene.domain_end == (5.0, 3.0, 2.0)
    assert scene.particle_radius == 0.01
    assert scene.support_length == pytest.approx(0.04)
    assert scene.padding == pytest.approx(0.04)
    assert scene.particle_volume0 == pytest.approx(0.8 * 0.02**3)
    fb = scene.fluid_blocks[0]
    assert fb.velocity == (0.0, -1.0, 10.0)
    assert np.allclose(fb.color, (50 / 255, 100 / 255, 200 / 255))
    # ignored-by-reference keys are retained
    assert scene.stiffness_B == 50000
    assert scene.dt == 4e-4


def test_2d_scene_without_dim_key():
    """demo_2d.json has no 'dim'; it must default from domainStart length."""
    raw = {
        "configuration": {
            "domainStart": [0.0, 0.0],
            "domainEnd": [5.0, 3.0],
            "particleRadius": 0.01,
            "density0": 1000,
            "gravitation": [0.0, -9.81],
        },
        "fluidBlocks": [
            {"start": [3, 1], "end": [6, 6], "velocity": [0, -20],
             "density": 1000.0, "color": [50, 100, 200]}
        ],
    }
    scene = tt.scene_from_dict(raw)
    assert scene.dim == 2
    assert scene.fluid_blocks[0].start == (3.0, 1.0)


def test_compat_presets():
    scene = tt.scene_from_dict(REFERENCE_STYLE_3D)
    ref = SolverParams.from_scene(scene, compat="reference")
    # reference-hardcoded constants (wcsphv2.py:10-11, sph_basev2.py:12,15)
    assert ref.stiffness == 50.0
    assert ref.dt == 2e-4
    assert ref.viscosity == 0.05
    cfg = SolverParams.from_scene(scene, compat="config")
    # honored config keys
    assert cfg.stiffness == 50000.0
    assert cfg.dt == 4e-4
    assert cfg.viscosity == 0.01
    with pytest.raises(ValueError):
        SolverParams.from_scene(scene, compat="bogus")


def test_load_scene_file(tmp_path):
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(REFERENCE_STYLE_3D))
    scene = tt.load_scene(p)
    assert scene.base_dir == str(tmp_path)
    assert scene.c_s == 88.5


def test_emitter_parsing():
    raw = dict(REFERENCE_STYLE_3D)
    raw["emitters"] = [
        {"start": [0.1, 2.0, 0.5], "end": [0.3, 2.0, 0.7],
         "velocity": [0, -3.0, 0], "interval": 10, "maxParticles": 5000}
    ]
    scene = tt.scene_from_dict(raw)
    assert len(scene.emitters) == 1
    assert scene.emitters[0].interval == 10
    assert scene.emitters[0].max_particles == 5000
