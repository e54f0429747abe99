"""Per-phase timing of one WCSPH step on the card.

Decomposes the Pallas seg step (models/wcsph.py:_seg_build/_seg_apply) into
isolated jitted pieces and times each with block_until_ready, so ROADMAP's
perf levers can be attributed to the phase they actually move.

Usage:  python tools/profile_step.py [scene.json] [--reps 20]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import jax
import jax.numpy as jnp

import tisph as tt
from tisph.ops import forces as F
from tisph.ops import grid as gridops
from tisph.ops.pallas import sweeps as ps


def timeit(fn, args, reps, warmup=2):
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
    ap.add_argument("scene", nargs="?", default="scenes/demo_3d.json")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--block", type=int, default=None)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--settle", type=int, default=50,
                    help="steps to run before measuring (mid-collapse state)")
    ap.add_argument("--resort", type=int, default=1,
                    help="resort_every amortization factor; the "
                         "full-step row then times a whole R-substep group "
                         "via rollout (per-substep cost = group / R)")
    args = ap.parse_args()

    scene = tt.load_scene(args.scene)
    state = tt.build_state(scene)
    solver = tt.WCSPH(scene)
    state = solver.bind(state)
    scfg = solver.sweep_cfg
    if scfg.impl != "pallas":
        raise SystemExit(f"profiles the pallas sweeps; this backend runs "
                         f"{scfg.impl!r}")
    if args.block or args.window:
        scfg = dataclasses.replace(
            scfg,
            block_size=args.block or scfg.block_size,
            window_cap=args.window or scfg.window_cap,
        )
        solver.sweep_cfg = scfg
        state = solver.bind(state)
    spec, params = solver.spec, solver.params
    n = int(jax.device_get(state.num_active))
    print(f"n={n}  impl={scfg.impl} block={scfg.block_size} "
          f"window={scfg.window_cap} cap={state.capacity}")

    # settle so the measured configuration is mid-collapse
    state = solver.rollout(state, args.settle)
    jax.block_until_ready(state.x)

    if args.resort > 1:
        solver.sweep_cfg = scfg = dataclasses.replace(
            scfg, resort_every=args.resort
        )
        solver._rollout_jit = None  # pick up the amortized rollout
        roll = lambda st: solver.rollout(st, args.resort)
        t_full = timeit(roll, (state,), args.reps) / args.resort
    else:
        full = jax.jit(solver._step_fn)
        t_full = timeit(full, (state,), args.reps)

    sort = jax.jit(lambda st: gridops.sort_state_by_cell(st, spec))
    t_sort = timeit(sort, (state,), args.reps)
    st_s, ids, _ = sort(state)

    pack_fn = jax.jit(
        lambda st, ids: ps.pack_state(
            st.x, st.v, st.density, st.pressure, st.mass, st.volume,
            st.material, ids, params,
        )
    )
    t_pack = timeit(pack_fn, (st_s, ids), args.reps)
    pack = pack_fn(st_s, ids)
    block_cap = scfg.pad_capacity // scfg.block_size
    plan_fn = jax.jit(
        lambda ids: gridops.seg_plan(ids, spec, scfg.block_size, block_cap)
    )
    t_plan = timeit(plan_fn, (ids,), args.reps)
    plan = plan_fn(ids)
    meta_fn = jax.jit(
        lambda plan, ids: ps.seg_block_meta(
            plan, ids, spec, scfg.block_size, scfg.window_cap,
        )
    )
    t_meta = timeit(meta_fn, (plan, ids), args.reps)
    meta, _ = meta_fn(plan, ids)
    dens_fn = lambda pack, meta: ps.density_sweep_seg(
        pack, meta, spec, params, scfg.block_size)
    force_fn = lambda pack, meta: ps.force_sweep_seg(
        pack, meta, spec, params, scfg.block_size)

    dens = jax.jit(dens_fn)
    t_dens = timeit(dens, (pack, meta), args.reps)

    force = jax.jit(force_fn)
    t_force = timeit(force, (pack, meta), args.reps)

    eos = jax.jit(lambda rho: F.compute_pressures(rho, params))
    rho = dens(pack, meta)[: st_s.capacity]
    t_eos = timeit(eos, (rho,), args.reps)

    adv = jax.jit(
        lambda st, dv: F.enforce_domain_boundary(F.advect(st, dv, params), params)
    )
    dv = force(pack, meta)[: st_s.capacity]
    t_adv = timeit(adv, (st_s, dv), args.reps)

    t_repack = timeit(
        jax.jit(lambda p, r: ps.repack_eos(p, r, r)), (pack, rho), args.reps
    )

    # dispatch-latency floor: a trivial jitted op on a step-sized array,
    # timed the same way.  EVERY isolated phase number above includes ~this
    # much per-dispatch overhead, which
    # the real step pays ONCE for the whole fused graph — so "sum of
    # parts" systematically overcounts small phases by ~(num_phases x
    # null).  Subtract it before attributing cost to a phase.
    null = jax.jit(lambda r: r + 1.0)
    t_null = timeit(null, (rho,), args.reps)

    occ = int(jax.device_get(state.occ_window))
    parts = {
        "sort": t_sort, "plan": t_plan, "meta": t_meta, "pack": t_pack,
        "density": t_dens, "repack": t_repack, "force": t_force,
        "eos": t_eos, "advect+clamp": t_adv,
    }
    print(f"full step        : {t_full:8.2f} ms   ({n / t_full * 1000:.3g} pps)")
    for k, v in parts.items():
        print(f"{k:17}: {v:8.2f} ms   (net {v - t_null:6.2f})")
    print(f"sum of parts     : {sum(parts.values()):8.2f} ms")
    print(f"null dispatch    : {t_null:8.2f} ms   (per-dispatch overhead "
          f"included in every row above)")
    print(f"occ_window (50 steps in): {occ} / cap {scfg.window_cap}")


if __name__ == "__main__":
    main()
