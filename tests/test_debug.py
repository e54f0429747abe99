"""Debug/validation utilities (SURVEY.md §5.2 build requirement)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tisph as tt
from tisph.utils.debug import checked_step, validate_state


@pytest.fixture(scope="module")
def bound():
    scene = tt.load_scene("scenes/demo_2d.json")
    state = tt.build_state(scene)
    solver = tt.WCSPH(scene)
    state = solver.bind(state)
    return scene, solver, state


def test_validate_clean_state(bound):
    _, solver, state = bound
    assert validate_state(state, solver.params, strict=False) == []


def test_validate_catches_nan(bound):
    _, solver, state = bound
    bad = dataclasses.replace(state, x=state.x.at[0, 0].set(jnp.nan))
    problems = validate_state(bad, solver.params, strict=False)
    assert any("non-finite positions" in p for p in problems)
    with pytest.raises(AssertionError):
        validate_state(bad, solver.params, strict=True)


def test_validate_catches_escape(bound):
    _, solver, state = bound
    bad = dataclasses.replace(state, x=state.x.at[0, 0].set(99.0))
    problems = validate_state(bad, solver.params, strict=False)
    assert any("outside the domain" in p for p in problems)


def test_checked_step_clean(bound):
    _, solver, state = bound
    step = jax.jit(checked_step(solver._step_fn, solver.params))
    err, out = step(state)
    err.throw()  # no error
    assert np.isfinite(np.asarray(out.x)).all()


def test_checked_step_detects_nan(bound):
    _, solver, state = bound
    bad = dataclasses.replace(state, v=state.v.at[5, 0].set(jnp.nan))
    step = jax.jit(checked_step(solver._step_fn, solver.params))
    err, _ = step(bad)
    with pytest.raises(Exception, match="non-finite"):
        err.throw()
