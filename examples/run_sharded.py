"""Multi-chip example: the sharded WCSPH solver over a 1-D device mesh,
or the rectangle decomposition (2-axis x × y, or 3-axis x × y × z box)
via --mesh2d.

On a multi-GPU host this runs across the cards; use CPU device emulation
to exercise the same collectives (the Pallas kernels then run in
interpret mode):

    python examples/run_sharded.py scenes/demo_3d.json --devices 4
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/run_sharded.py scenes/demo_3d.json --devices 8 --cpu
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python examples/run_sharded.py scenes/demo_3d.json --mesh2d 4x2 --cpu
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--mesh2d", default=None, metavar="SXxSY[xSZ]",
                    help="use the rectangle decomposition "
                    "(ShardedWCSPHRect) on an SXxSY (or SXxSYxSZ box) mesh")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (for device emulation)")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    import tisph as tt
    from tisph.ops.neighbors import SweepConfig
    from tisph.utils.compile_cache import use_compile_cache
    from tisph.parallel import (
        ShardedWCSPH, ShardedWCSPHRect, make_mesh, make_mesh2d, make_mesh3d,
    )

    use_compile_cache()
    scene = tt.load_scene(args.scene)
    state = tt.build_state(scene)
    if args.mesh2d:
        try:
            sizes = tuple(map(int, args.mesh2d.lower().split("x")))
        except ValueError:
            sizes = ()
        if len(sizes) not in (2, 3) or any(s < 1 for s in sizes):
            ap.error(f"--mesh2d expects SXxSY or SXxSYxSZ (e.g. 4x2 or "
                     f"2x2x2), got {args.mesh2d!r}")
        mesh = (make_mesh2d(*sizes) if len(sizes) == 2
                else make_mesh3d(*sizes))
        print(f"mesh: {'x'.join(map(str, sizes))} "
              f"({mesh.devices.ravel()[0].platform})")
        # the rect meshes run the Pallas sweeps only: compiled on GPUs, in
        # interpret mode on the emulated CPU mesh
        cfg = (SweepConfig(impl="pallas", interpret=True)
               if mesh.devices.ravel()[0].platform == "cpu" else None)
        solver = ShardedWCSPHRect(scene, mesh, sweep_cfg=cfg)
        state = solver.bind(state)
        bufs = "/".join(f"H{L}={getattr(solver, f'cap_h{L}')}"
                        for L in solver._letters)
        print(f"particles: {int(jax.device_get(state.num_active))}, "
              f"halo bufs {bufs} rows, shard={solver._shard_rows} rows")
    else:
        mesh = make_mesh(args.devices)
        print(f"mesh: {mesh.devices.size} devices "
              f"({mesh.devices.ravel()[0].platform})")
        solver = ShardedWCSPH(scene, mesh)
        state = solver.bind(state)
        print(f"particles: {int(jax.device_get(state.num_active))}, "
              f"halo={solver.halo} rows, shard={solver._shard_rows} rows")

    if scene.emitters:
        # emitter scenes: the fused (emit -> step) rollout composes with
        # both meshes (1-D: global tail pool; 2-D: per-shard tails)
        from tisph.geometry.emitter import make_emitter_state

        emitters = [make_emitter_state(e, scene) for e in scene.emitters]
        # warm up with the SAME static num_steps (rollout_emit jits with
        # static_argnums: a different n is a different program, and a
        # warm-up at n=1 would leave the full trace+compile inside the
        # timed region); results are discarded so the timed rollout still
        # starts from the initial state
        warm = solver.rollout_emit(state, emitters, args.steps)
        jax.block_until_ready(warm[0].x)
        t0 = time.time()
        state, emitters = solver.rollout_emit(state, emitters, args.steps)
        jax.block_until_ready(state.x)
        wall = time.time() - t0
        print(f"emitted: {int(jax.device_get(emitters[0].emitted))}")
    else:
        state = solver.step(state)  # compile
        jax.block_until_ready(state.x)
        t0 = time.time()
        for _ in range(args.steps):
            state = solver.step(state)
        jax.block_until_ready(state.x)
        wall = time.time() - t0
    n = int(jax.device_get(state.num_active))
    m = jax.device_get(solver.metrics(state))
    print(f"{args.steps} steps in {wall:.2f}s -> {n * args.steps / wall:.3e} "
          f"particle-steps/sec; vmax={float(m['max_velocity']):.3f} "
          f"nan={int(m['nan_count'])}")
    # rect meshes only: the 1-D class has no fixed per-shard cut (its
    # exchange resort falls back to a lossless global sort instead)
    used = int(m.get("shard_rows_used", 0))
    budget = int(m.get("shard_rows", 0))
    if budget and used > budget:
        print(f"ERROR: a shard needed {used} rows > budget {budget} — the "
              f"rebuild cut dropped particles; rerun with a larger "
              f"balance_slack or more shards (solver.run() steers this "
              f"automatically)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
