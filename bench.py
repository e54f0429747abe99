"""Benchmark: particle-steps/sec on the 3D WCSPH dam break (BASELINE.md).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.
vs_baseline is measured against the driver-set north star of 1e9
particle-steps/sec (BASELINE.json; the reference publishes no numbers —
SURVEY.md §6).

Scene: scenes/demo_3d.json (the reference's flagship main_3d.py workload,
~195k particles at radius spacing).  Override with BENCH_SCENE /
BENCH_STEPS env vars.
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

import tisph as tt
from tisph.utils.compile_cache import use_compile_cache

NORTH_STAR = 1e9  # particle-steps/sec (BASELINE.json)


def _measure(solver, state, steps: int, resort: int):
    """Timed rollout at a given resort_every; returns (state, pps) or
    (state, None) on NaN."""
    import dataclasses

    if (
        solver.sweep_cfg is not None
        and solver.sweep_cfg.impl == "pallas"
        and int(getattr(solver.sweep_cfg, "resort_every", 1) or 1) != resort
    ):
        solver.sweep_cfg = dataclasses.replace(
            solver.sweep_cfg, resort_every=resort
        )
        solver._rollout_jit = None

    n = int(jax.device_get(state.num_active))
    # chunk the rollout (bounded dispatches) and pre-compile every chunk
    # shape OUTSIDE the timed region
    chunk = min(200, steps)
    shapes = {chunk}
    if steps % chunk:
        shapes.add(steps % chunk)
    for k in sorted(shapes):
        state = solver.rollout(state, k)  # warmup/compile
    jax.block_until_ready(state.x)

    t0 = time.perf_counter()
    done = 0
    while done < steps:
        k = min(chunk, steps - done)
        state = solver.rollout(state, k)
        done += k
    jax.block_until_ready(state.x)
    wall = time.perf_counter() - t0

    # sanity: simulation must stay healthy or the number is meaningless
    m = jax.device_get(solver.metrics(state))
    if float(m["nan_count"]) != 0:
        return state, None
    return state, n * steps / wall


def _main_once(scene_path: str, steps: int) -> int:
    scene = tt.load_scene(scene_path)
    state = tt.build_state(scene)
    solver = tt.WCSPH(scene)
    state = solver.bind(state)
    n = int(jax.device_get(state.num_active))

    # Amortized resort (pallas sweeps): rebuild sort/plan/meta every R
    # substeps (measured on demo_3d @200 steps vs per-substep resort,
    # tools/compare_resort.py: R=2 position RMSE = 0.13 h / p99 = 0.50 h;
    # R=3 RMSE = 0.29 h / p99 = 1.08 h).  The headline value is R=2;
    # ``r1_pps`` reports the same run at the reference's exact
    # per-substep cadence (R=1) so both numbers are always on record.
    # BENCH_RESORT overrides the headline cadence.
    amortizable = (
        solver.sweep_cfg is not None and solver.sweep_cfg.impl == "pallas"
    )
    resort = int(os.environ.get("BENCH_RESORT", "2")) if amortizable else 1
    state, pps = _measure(solver, state, steps, resort)
    if pps is None:
        print(json.dumps({"metric": "particle-steps/sec", "value": 0.0,
                          "unit": "pps", "vs_baseline": 0.0,
                          "error": "NaN during benchmark"}))
        return 1
    extra = {}
    if resort != 1:
        state, r1_pps = _measure(solver, state, steps, 1)
        if r1_pps is not None:
            extra["r1_pps"] = round(r1_pps, 1)
            if r1_pps > pps:
                # the amortized cadence lost — report the winner AS the
                # cadence it actually ran at (never attribute an R=1
                # number to resort_every=2)
                pps = r1_pps
                resort = 1
    extra["resort_every"] = resort
    dev = jax.devices()[0]
    extra["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())}
    print(json.dumps({
        "metric": "particle-steps/sec (3D dam break, %dk particles)" % (n // 1000),
        "value": round(pps, 1),
        "unit": "particle-steps/sec",
        "vs_baseline": round(pps / NORTH_STAR, 6),
        **extra,
    }))
    return 0


def main() -> int:
    scene_path = os.environ.get(
        "BENCH_SCENE", os.path.join(os.path.dirname(__file__), "scenes", "demo_3d.json")
    )
    steps = int(os.environ.get("BENCH_STEPS", "50"))
    use_compile_cache()
    return _main_once(scene_path, steps)


if __name__ == "__main__":
    sys.exit(main())
