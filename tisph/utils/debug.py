"""Debug-mode validation (SURVEY.md §5.2).

The reference's only sanitizer is Taichi debug mode + in-kernel asserts
(main_ggui.py:5, partice_systemv4.py:88).  JAX is race-free by
construction; what remains worth checking is numeric health and domain
invariants:

- :func:`validate_state` — host-side assertion sweep over a SimState
  (finite values, positions in domain, density >= clamp, mass/volume > 0
  for active particles);
- :func:`checked_step` — wraps a solver step with ``jax.experimental
  .checkify`` so NaN/OOB checks run ON DEVICE inside jit and surface as
  errors instead of silent corruption.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from tisph.config import SolverParams
from tisph.models.state import SimState, MATERIAL_INVALID


def validate_state(state: SimState, params: SolverParams, strict: bool = True) -> list[str]:
    """Host-side invariant sweep; returns a list of violation messages
    (raises AssertionError when ``strict`` and violations exist)."""
    host = jax.device_get(state)
    mat = np.asarray(host.material)
    act = mat != MATERIAL_INVALID
    x = np.asarray(host.x)[act]
    v = np.asarray(host.v)[act]
    problems: list[str] = []

    if not np.isfinite(x).all():
        problems.append(f"non-finite positions: {(~np.isfinite(x)).sum()} values")
    if not np.isfinite(v).all():
        problems.append(f"non-finite velocities: {(~np.isfinite(v)).sum()} values")
    lo = np.asarray(params.domain_start)
    hi = np.asarray(params.domain_end)
    if x.size and ((x < lo - 1e-5).any() or (x > hi + 1e-5).any()):
        problems.append("particles outside the domain box")
    m = np.asarray(host.mass)[act]
    vol = np.asarray(host.volume)[act]
    if x.size and ((m <= 0).any() or (vol <= 0).any()):
        problems.append("non-positive mass/volume on active particles")
    n_active = int(np.asarray(host.num_active))
    if act.sum() != n_active:
        problems.append(
            f"num_active ({n_active}) != active material count ({act.sum()})"
        )
    if strict and problems:
        raise AssertionError("; ".join(problems))
    return problems


def checked_step(step_fn, params: SolverParams | None = None):
    """Wrap a pure step function with on-device output checks (checkify).

    Checks the step's RESULT (finite positions/velocities/density, positions
    inside the domain) rather than every intermediate op: the vectorised
    sweeps intentionally produce garbage on masked-out lanes (0/0 on
    inactive padding) which ``jnp.where`` discards, so blanket float checks
    would false-positive by design.

    >>> step = checked_step(solver._step_fn, solver.params)
    >>> err, state = jax.jit(step)(state)
    >>> err.throw()   # raises on the host if any check fired on device
    """
    from jax.experimental import checkify

    def wrapped(state: SimState) -> SimState:
        out = step_fn(state)
        act = out.material != MATERIAL_INVALID
        checkify.check(
            jnp.all(jnp.isfinite(jnp.where(act[:, None], out.x, 0.0))),
            "non-finite positions after step",
        )
        checkify.check(
            jnp.all(jnp.isfinite(jnp.where(act[:, None], out.v, 0.0))),
            "non-finite velocities after step",
        )
        checkify.check(
            jnp.all(jnp.isfinite(jnp.where(act, out.density, 0.0))),
            "non-finite densities after step",
        )
        if params is not None:
            lo = jnp.asarray(params.domain_start) - 1e-5
            hi = jnp.asarray(params.domain_end) + 1e-5
            inside = jnp.where(
                act[:, None], (out.x >= lo) & (out.x <= hi), True
            )
            checkify.check(jnp.all(inside), "particles left the domain box")
        return out

    return checkify.checkify(wrapped)
