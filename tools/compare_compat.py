"""Quantify intended-vs-shipped divergence: position RMSE between
``compat="reference"`` (intended equations) and ``compat="reference-exact"``
(the reference's bugs replayed bit-for-bit: V2 density overwritten with the
self term => pressure identically 0, wcsphv2.py:29-34; V1 domain clamp never
called, sph_base.py:166).

Run on CPU (small scenes):
    python tools/compare_compat.py scenes/demo_2d.json --frames 20 \
        --substeps 5 --json

The RMSE table this prints backs the README's fidelity section: it turns
"we implement the intended equations, the reference's are buggy" from an
argument into a measurement.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp

import tisph as tt


def run(scene_path: str, compat: str, solver_name: str, frames: int,
        substeps: int, cpu: bool):
    import dataclasses

    scene = tt.load_scene(scene_path)
    cls = tt.WCSPH if solver_name == "wcsph" else tt.WCSPHLegacy
    solver = cls(scene, compat=compat)
    state = tt.build_state(scene)
    state = solver.bind(state)
    # the step resorts the SoA every substep, and the two modes' trajectories
    # sort differently — stamp object_id (unused by the plain solvers) with
    # the original index and unpermute every snapshot so index = particle
    state = dataclasses.replace(
        state, object_id=jnp.arange(state.capacity, dtype=jnp.int32)
    )
    snaps = []
    for _ in range(frames):
        state = solver.rollout(state, substeps)
        inv = jnp.argsort(state.object_id)
        snaps.append(state.x[inv])
    return jnp.stack(snaps), dataclasses.replace(
        state,
        x=state.x[inv], material=state.material[inv],
    )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="scenes/demo_2d.json")
    ap.add_argument("--solver", choices=["wcsph", "legacy"], default="wcsph")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--substeps", type=int, default=5)
    ap.add_argument("--device", action="store_true",
                    help="run on the default backend (the GPU) instead of CPU")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    if not args.device:
        jax.config.update("jax_platforms", "cpu")

    xs_int, st_int = run(args.scene, "reference", args.solver,
                         args.frames, args.substeps, not args.device)
    xs_ref, st_ref = run(args.scene, "reference-exact", args.solver,
                         args.frames, args.substeps, not args.device)

    active = st_int.fluid_mask
    diff2 = jnp.sum((xs_int - xs_ref) ** 2, axis=-1)  # (frames, cap)
    nact = jnp.maximum(jnp.sum(active), 1)
    rmse = jnp.sqrt(jnp.sum(jnp.where(active[None], diff2, 0.0), axis=1) / nact)
    rmse = jax.device_get(rmse)
    h = tt.load_scene(args.scene).support_length

    rows = []
    for i, r in enumerate(rmse):
        step = (i + 1) * args.substeps
        rows.append({"step": step, "rmse": float(r), "rmse_over_h": float(r / h)})
    if args.json:
        print(json.dumps({
            "scene": args.scene, "solver": args.solver, "h": h,
            "rmse_final": rows[-1]["rmse"], "rows": rows,
        }))
    else:
        print(f"{args.scene} [{args.solver}]  intended vs reference-exact")
        print(f"{'step':>6}  {'pos RMSE':>12}  {'RMSE / h':>10}")
        for row in rows:
            print(f"{row['step']:6d}  {row['rmse']:12.6f}  {row['rmse_over_h']:10.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
