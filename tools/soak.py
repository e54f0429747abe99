"""10k-step full dam-break soak on the card.

Runs the flagship scene end-to-end through SolverBase.run's adaptive
recapacity loop (the path a production user hits), counting regrow
recompiles and validating the final state, and prints (and optionally
writes) a JSON record.

Usage:  python tools/soak.py [scene.json] [--steps 10000] [--resort 2]
            [--out soak.json]
"""

from __future__ import annotations

import argparse
import json
import time

import jax

import tisph as tt


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="scenes/demo_3d.json")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--resort", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--chunk", type=int, default=400,
                    help="max steps per dispatch (SolverBase.run's "
                    "check_every / max_dispatch)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (smoke testing)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    scene = tt.load_scene(args.scene)
    state = tt.build_state(scene)
    solver = tt.WCSPH(scene)
    state = solver.bind(state)
    if solver.sweep_cfg is not None and solver.sweep_cfg.impl == "pallas":
        import dataclasses

        solver.sweep_cfg = dataclasses.replace(
            solver.sweep_cfg, resort_every=args.resort
        )
        solver._rollout_jit = None
    n = int(jax.device_get(state.num_active))

    regrows: list[dict] = []
    orig_regrow = solver.regrow

    def counting_regrow(new_window=None, new_pad=None):
        regrows.append({"window": new_window, "pad": new_pad,
                        "t": round(time.perf_counter() - t0, 1)})
        return orig_regrow(new_window=new_window, new_pad=new_pad)

    solver.regrow = counting_regrow

    t0 = time.perf_counter()
    state = solver.run(state, args.steps, verbose=True,
                       check_every=args.chunk, max_dispatch=args.chunk)
    jax.block_until_ready(state.x)
    wall = time.perf_counter() - t0

    m = {k: float(v) for k, v in jax.device_get(solver.metrics(state)).items()}
    rec = {
        "scene": args.scene,
        "particles": n,
        "steps": args.steps,
        "resort_every": args.resort,
        "wall_s": round(wall, 1),
        "pps_wall": round(n * args.steps / wall, 1),
        "sim_seconds": args.steps * float(solver.params.dt),
        "regrow_events": regrows,
        "metrics": m,
        "device": str(jax.devices()[0]),
    }
    print(json.dumps(rec, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=2)
    # healthy = no NaNs and the pool has settled to sub-collapse speeds
    return 0 if m.get("nan_count", 1) == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
