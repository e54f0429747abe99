"""compat="reference-exact": the reference's shipped bugs, replayed.

- V2 (WCSPH): compute_densities overwrites the neighbor sum with the self
  term m_i W(0) (wcsphv2.py:29-34).  With radius-spacing sampling
  m_i W(0) = 0.8 * 8 * rho0 * (8/pi) / 64 ~= 318 < rho0, so the EOS clamp
  (wcsphv2.py:45) pins density to rho0 and pressure to EXACTLY 0 — the
  shipped flagship solver runs with no pressure forces at all.
- V1 (WCSPHLegacy): enforce_boundary's body is ``self.enforce_boundary_3D``
  with no call parens (sph_base.py:166) — the domain clamp never runs.
"""

import numpy as np
import jax
import pytest

import tisph as tt


def _rollout(scene_path, compat, steps, solver_cls=tt.WCSPH):
    scene = tt.load_scene(scene_path)
    solver = solver_cls(scene, compat=compat)
    state = solver.bind(tt.build_state(scene))
    return scene, jax.device_get(solver.rollout(state, steps))


def test_v2_reference_exact_pressure_is_zero():
    scene, state = _rollout("scenes/demo_2d.json", "reference-exact", steps=10)
    n = int(state.num_active)
    rho = np.asarray(state.density)[:n]
    p = np.asarray(state.pressure)[:n]
    # overwritten density clamps to rho0 for every particle => p == 0
    np.testing.assert_allclose(rho, scene.density0, rtol=1e-6)
    np.testing.assert_allclose(p, 0.0, atol=1e-6)


def test_v2_reference_exact_diverges_from_intended():
    _, st_exact = _rollout("scenes/demo_2d.json", "reference-exact", steps=40)
    _, st_int = _rollout("scenes/demo_2d.json", "reference", steps=40)
    n = int(st_int.num_active)
    d = np.linalg.norm(
        np.asarray(st_exact.x)[:n] - np.asarray(st_int.x)[:n], axis=-1
    )
    # without pressure the dam compresses: measurable divergence, no NaN
    assert np.isfinite(np.asarray(st_exact.x)[:n]).all()
    assert d.max() > 1e-4


def test_v1_reference_exact_never_clamps():
    """A fluid particle pushed out of the box stays out (no domain clamp)."""
    scene = tt.load_scene("scenes/demo_2d.json")
    solver = tt.WCSPHLegacy(scene, compat="reference-exact")
    state = solver.bind(tt.build_state(scene))
    import dataclasses
    import jax.numpy as jnp

    # teleport one fluid particle outside the domain with outward velocity
    idx = int(np.argmax(np.asarray(state.material) == 1))
    x = state.x.at[idx, 0].set(scene.domain_end[0] + 0.5)
    v = state.v.at[idx, 0].set(5.0)
    state = dataclasses.replace(state, x=x, v=v)
    def max_fluid_x(st):
        active_fluid = np.asarray(st.material) == 1
        return float(np.asarray(st.x)[active_fluid, 0].max())

    # the step resorts particles, so track the runaway via the max fluid x
    out = jax.device_get(solver.rollout(state, 3))
    assert max_fluid_x(out) > scene.domain_end[0]  # still outside
    # and the intended mode does clamp it back in
    solver2 = tt.WCSPHLegacy(scene, compat="reference")
    out2 = jax.device_get(solver2.rollout(state, 3))
    assert max_fluid_x(out2) <= scene.domain_end[0] - scene.padding + 1e-5
