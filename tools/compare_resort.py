"""Physics divergence of the amortized resort (SweepConfig.resort_every=R)
vs the exact per-substep resort, on the flagship scene.

    python tools/compare_resort.py [scene] --resort 3 --steps 200

Prints position RMSE / max (identity-tracked via object_id) in units of the
support length h — the number that justifies (or forbids) using R>1 for the
headline benchmark.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

import tisph as tt


def roll(scene, resort_every, steps, chunk=100):
    solver = tt.WCSPH(scene)
    state = solver.bind(tt.build_state(scene))
    if resort_every > 1:
        solver.sweep_cfg = dataclasses.replace(
            solver.sweep_cfg, resort_every=resort_every
        )
        solver._rollout_jit = None
    state = dataclasses.replace(
        state, object_id=jnp.arange(state.capacity, dtype=jnp.int32)
    )
    done = 0
    while done < steps:
        k = min(chunk, steps - done)
        state = solver.rollout(state, k)
        done += k
    inv = jnp.argsort(state.object_id)
    x = state.x[inv]
    mat = state.material[inv]
    return np.asarray(jax.device_get(x)), np.asarray(jax.device_get(mat))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="scenes/demo_3d.json")
    ap.add_argument("--resort", type=int, default=3)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()

    scene = tt.load_scene(args.scene)
    x1, m1 = roll(scene, 1, args.steps)
    xr, mr = roll(scene, args.resort, args.steps)
    act = m1 == 1
    d = np.linalg.norm(x1[act] - xr[act], axis=-1)
    h = scene.support_length
    out = {
        "scene": args.scene, "steps": args.steps, "resort_every": args.resort,
        "h": h,
        "rmse": float(np.sqrt((d ** 2).mean())),
        "rmse_over_h": float(np.sqrt((d ** 2).mean()) / h),
        "max_over_h": float(d.max() / h),
        "p99_over_h": float(np.percentile(d, 99) / h),
    }
    if args.json:
        print(json.dumps(out))
    else:
        for k, v in out.items():
            print(f"{k}: {v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
