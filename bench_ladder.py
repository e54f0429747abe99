"""BASELINE measurement ladder (BASELINE.md: configs 1-5).

Runs each config and prints one JSON line per config.  The headline
single-number benchmark stays in bench.py.

Configs (BASELINE.json):
  1. 2D WCSPH dam break ~5k, box boundary
  2. 2D WCSPH + static boundary-particle obstacles + surface tension/viscosity
  3. 3D WCSPH dam break ~100k
  4. 3D + imported boundary mesh + emitter inflow, 500k+
  5. 1M-particle 3D + in-loop BPA surface extraction + frame export
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax
import numpy as np

import tisph as tt
from tisph.utils.compile_cache import use_compile_cache

HERE = os.path.dirname(os.path.abspath(__file__))

LADDER = [
    ("2d_5k", "scenes/bench_2d_5k.json", 100, {}),
    ("2d_obstacle", "scenes/bench_2d_obstacle.json", 100, {}),
    ("3d_100k", "scenes/bench_3d_100k.json", 50, {}),
    ("3d_mesh_emitter_500k", "scenes/bench_3d_mesh_500k.json", 30, {"emit": True}),
    ("3d_1m_bpa", "scenes/bench_3d_1m.json", 30, {"bpa": True, "export": True}),
    ("3d_rigid_coupled", "scenes/bench_3d_rigid.json", 30, {"rigid": True}),
]


def _apply_resort(solver) -> int:
    """bench.py's headline cadence (resort_every=2, BENCH_RESORT overrides)
    on the pallas sweeps; returns the cadence actually applied."""
    import dataclasses

    resort = int(os.environ.get("BENCH_RESORT", "2"))
    cfg = solver.sweep_cfg
    if resort != 1 and cfg is not None and cfg.impl == "pallas":
        solver.sweep_cfg = dataclasses.replace(cfg, resort_every=resort)
        return resort
    return 1


def run_config(name: str, scene_path: str, steps: int, opts: dict) -> dict:
    scene = tt.load_scene(os.path.join(HERE, scene_path))
    state = tt.build_state(scene)
    if opts.get("rigid"):
        from tisph.models.wcsph_rigid import WCSPHRigid

        solver = WCSPHRigid(scene)
        state = solver.bind(state)
        resort = _apply_resort(solver)
        rigid = solver.init_rigid(state)
        n = int(jax.device_get(state.num_active))
        # warmup compiles the exact dispatch shape (also settles 1 chunk)
        state, rigid = solver.rollout_coupled(state, rigid, steps)
        jax.block_until_ready(state.x)
        t0 = time.perf_counter()
        state, rigid = solver.rollout_coupled(state, rigid, steps)
        jax.block_until_ready(state.x)
        wall = time.perf_counter() - t0
        m = jax.device_get(solver.metrics(state))
        return {
            "config": name,
            "particles": n,
            "steps": steps,
            "wall_s": round(wall, 3),
            "particle_steps_per_sec": round(n * steps / wall, 1),
            "nan": int(m["nan_count"]),
            "sweep": solver.sweep_cfg.impl,
            "resort": resort,
        }
    solver = tt.WCSPH(scene)
    state = solver.bind(state)
    resort = _apply_resort(solver)
    n = int(jax.device_get(state.num_active))

    emitters = []
    if opts.get("emit") and scene.emitters:
        from tisph.geometry.emitter import make_emitter_state

        emitters = [make_emitter_state(em, scene) for em in scene.emitters]

    if emitters:
        # fused rollout: whole chunk in one dispatch; warmup compiles the
        # exact dispatch shape
        state, emitters = solver.rollout_emit(state, emitters, steps)
        jax.block_until_ready(state.x)
        t0 = time.perf_counter()
        state, emitters = solver.rollout_emit(state, emitters, steps)
        jax.block_until_ready(state.x)
        wall = time.perf_counter() - t0
    else:
        state = solver.rollout(state, steps)  # warmup: exact dispatch shape
        jax.block_until_ready(state.x)
        t0 = time.perf_counter()
        state = solver.rollout(state, steps)
        jax.block_until_ready(state.x)
        wall = time.perf_counter() - t0

    extra = {}
    if opts.get("export"):
        t1 = time.perf_counter()
        from tisph.models.state import state_to_host

        host = state_to_host(state)
        extra["export_s"] = round(time.perf_counter() - t1, 3)
    if opts.get("bpa"):
        t1 = time.perf_counter()
        from tisph.models.state import state_to_host
        from tisph.render.bpa2d import extract_boundary_2d

        host = state_to_host(state)
        fluid = host["material"] == 1
        pts = host["x"][fluid][:, :2]  # xy projection boundary
        b = extract_boundary_2d(pts, radius=3.0 * scene.particle_radius)
        extra["bpa_s"] = round(time.perf_counter() - t1, 3)
        extra["bpa_loops"] = len(b.loops)

    m = jax.device_get(solver.metrics(state))
    n_final = int(jax.device_get(state.num_active))
    res = {
        "config": name,
        "particles": n_final,
        "steps": steps,
        "wall_s": round(wall, 3),
        "particle_steps_per_sec": round(n * steps / wall, 1),
        "nan": int(m["nan_count"]),
        "sweep": solver.sweep_cfg.impl,
        "resort": resort,
        **extra,
    }
    return res


def main() -> int:
    only = sys.argv[1] if len(sys.argv) > 1 else None
    use_compile_cache()
    for name, path, steps, opts in LADDER:
        if only and only not in name:
            continue
        res = run_config(name, path, steps, opts)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
