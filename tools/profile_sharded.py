"""Per-phase timing of the sharded WCSPH step on a (virtual) device mesh.

The sharded analog of tools/profile_step.py (VERDICT r2 #4): decomposes
one ShardedWCSPH step into resort (distributed sort + migration), seg
structure build (plan + window meta, per shard), halo value exchange, and
the apply phase (exchange + sweeps + advect), each timed with
block_until_ready.  Also times an amortized R-substep group so the
rebuild amortization is visible.

Absolute numbers on the virtual CPU mesh are CPU-bound (and the Pallas
kernels run in interpret mode there); the deliverable is the RELATIVE cost
structure (sort vs build vs exchange vs sweeps) and the amortization
ratio.  ``--platform gpu`` runs the same on the cards, compiled.

Usage:
    python tools/profile_sharded.py [--devices 8] [--radius 0.02]
        [--layout seg|blocked] [--resort 2] [--reps 5] [--platform cpu|gpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def timeit(fn, args, reps, warmup=1):
    import jax

    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3  # ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--radius", type=float, default=0.02)
    ap.add_argument("--layout", choices=["seg", "blocked"], default="seg")
    ap.add_argument("--resort", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--settle", type=int, default=10,
                    help="steps to run before measuring")
    ap.add_argument("--platform", choices=["cpu", "gpu"], default="cpu",
                    help="cpu (default): the virtual host mesh; gpu: the "
                         "cards (needs --devices of them)")
    args = ap.parse_args()

    if args.platform == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags
                + f" --xla_force_host_platform_device_count={args.devices}"
            ).strip()
    import jax

    jax.config.update("jax_platforms", args.platform)

    import tisph as tt
    from tisph.ops.neighbors import SweepConfig
    from tisph.parallel import ShardedWCSPH, make_mesh

    scene = tt.scene_from_dict(
        {
            "configuration": {
                "dim": 3,
                "domainStart": [0.0, 0.0, 0.0],
                "domainEnd": [1.0, 1.0, 1.0],
                "particleRadius": args.radius,
                "density0": 1000,
                "gravitation": [0.0, -9.81, 0.0],
                "c_s": 50.0,
            },
            "fluidBlocks": [
                {"start": [0.1, 0.1, 0.1], "end": [0.9, 0.6, 0.9],
                 "velocity": [0.0, -0.5, 0.2], "density": 1000.0,
                 "color": [50, 100, 200]}
            ],
            "rigidBodies": [],
        }
    )
    mesh = make_mesh(args.devices)
    platform = mesh.devices.ravel()[0].platform
    cfg = None
    if args.layout == "seg":
        cfg = SweepConfig(
            impl="pallas", block_size=128, window_cap=1152,
            interpret=(platform == "cpu"), resort_every=args.resort,
        )
    solver = ShardedWCSPH(scene, mesh, sweep_cfg=cfg)
    state = solver.bind(tt.build_state(scene))
    n = int(jax.device_get(state.num_active))
    hops = solver._hops()
    print(f"devices={args.devices} ({platform})  particles={n}  "
          f"capacity={state.capacity}  shard_rows={solver._shard_rows}")
    print(f"halo: depth={solver.halo} rows, hops={hops}, "
          f"path={'ppermute' if hops <= 2 else 'all_gather'}")
    state = solver.rollout(state, args.settle)
    jax.block_until_ready(state.x)

    rows: list[tuple[str, float]] = []

    def row(name, ms):
        rows.append((name, ms))
        print(f"{name:<22s}: {ms:8.2f} ms")

    step_ms = timeit(jax.jit(solver._step_fn), (state,), args.reps)
    row("full step (R=1)", step_ms)

    resort = jax.jit(lambda s: solver._global_resort(s)[0])
    row("resort (dist. sort)", timeit(resort, (state,), args.reps))

    if args.layout == "seg":
        build = jax.jit(lambda s: solver._seg_build(s))
        b_ms = timeit(build, (state,), args.reps)
        row("seg build (incl sort)", b_ms)
        st_b, cache = build(state)
        jax.block_until_ready(st_b.x)
        apply_ = jax.jit(lambda s, c: solver._seg_apply(s, c))
        row("seg apply (1 substep)", timeit(apply_, (st_b, cache), args.reps))

        # halo value exchange alone (the apply-phase collective cost)
        from functools import partial

        from jax.sharding import PartitionSpec as P

        from tisph.ops import forces as F
        from tisph.parallel.domain import _FIELD_KEYS

        ax = solver.axis
        hn, sr = solver.halo, solver._shard_rows

        @partial(jax.shard_map, mesh=mesh,
                 in_specs=(P(ax),) * (1 + len(_FIELD_KEYS)),
                 out_specs=P(ax), check_vma=False)
        def exchange(ids_l, *fields):
            arrs = dict(zip(_FIELD_KEYS, fields))
            ext, _ = solver._extend({**arrs, "ids": ids_l}, hn, hops, sr)
            # touch every channel so nothing is DCE'd
            import jax.numpy as jnp

            return sum(
                jnp.sum(v, axis=tuple(range(1, v.ndim)))
                if v.ndim > 1 else v
                for v in ext.values()
            )

        _, ids = jax.jit(solver._global_resort)(state)
        f = F.state_fields(st_b)
        row("halo exchange (x1)", timeit(
            jax.jit(exchange), (ids, *[f[k] for k in _FIELD_KEYS]), args.reps
        ))

        if args.resort > 1:
            R = args.resort
            grp = timeit(
                lambda s: solver.rollout(s, R), (state,), max(1, args.reps // 2)
            )
            row(f"R={R} group / R", grp / R)
            print(f"amortized speedup vs R=1 step: "
                  f"{step_ms / (grp / R):.2f}x")

    import json

    print(json.dumps({k: round(v, 2) for k, v in rows}))


if __name__ == "__main__":
    main()
