"""Microbenchmark the seg rebuild's metadata pieces on the card: which
primitive is actually slow (searchsorted vs sort-based vs histogram+cumsum
CSR), and the per-op cost of seg_plan / seg_block_meta.

    python tools/microbench_meta.py
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

import tisph as tt
from tisph.ops import grid as gridops
from tisph.ops.pallas import sweeps as ps


def timeit(fn, args, reps=20, warmup=2):
    for _ in range(warmup):
        out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def main():
    scene = tt.load_scene("scenes/demo_3d.json")
    solver = tt.WCSPH(scene)
    state = solver.bind(tt.build_state(scene))
    spec, scfg = solver.spec, solver.sweep_cfg
    state = solver.rollout(state, 50)
    jax.block_until_ready(state.x)
    st, ids, _ = jax.jit(lambda s: gridops.sort_state_by_cell(s, spec))(state)
    n = ids.shape[0]
    block = scfg.block_size
    block_cap = scfg.pad_capacity // block
    print(f"n={n} cells={spec.num_cells} block_cap={block_cap} "
          f"window={scfg.window_cap}")

    plan = jax.jit(lambda i: gridops.seg_plan(i, spec, block, block_cap))
    print(f"seg_plan              : {timeit(plan, (ids,)):7.2f} ms")
    p = plan(ids)
    meta = jax.jit(
        lambda p, i: ps.seg_block_meta(p, i, spec, block, scfg.window_cap)
    )
    print(f"seg_block_meta        : {timeit(meta, (p, ids)):7.2f} ms")

    # primitives
    nq = block_cap * spec.num_rows * 2
    q = jnp.linspace(0, spec.num_cells, nq).astype(ids.dtype)
    for method in ("scan", "scan_unrolled", "sort", "compare_all"):
        try:
            f = jax.jit(lambda i, q, m=method: jnp.searchsorted(i, q, method=m))
            print(f"searchsorted[{method:13}] {nq} queries: "
                  f"{timeit(f, (ids, q)):7.2f} ms")
        except Exception as e:
            print(f"searchsorted[{method}]: {type(e).__name__}")

    hist = jax.jit(
        lambda i: jnp.cumsum(
            jnp.zeros(spec.num_cells + 1, jnp.int32).at[
                jnp.minimum(i, spec.num_cells)
            ].add(1, mode="drop")
        )
    )
    print(f"histogram+cumsum CSR ({spec.num_cells} cells): "
          f"{timeit(hist, (ids,)):7.2f} ms")

    # same scatter with the sortedness declared (both call sites pass
    # cell-sorted ids) — lets XLA pick a sorted-scatter lowering
    dnums = jax.lax.ScatterDimensionNumbers(
        update_window_dims=(), inserted_window_dims=(0,),
        scatter_dims_to_operand_dims=(0,),
    )
    hist_s = jax.jit(
        lambda i: jnp.cumsum(
            jax.lax.scatter_add(
                jnp.zeros(spec.num_cells + 1, jnp.int32),
                jnp.minimum(i, spec.num_cells)[:, None],
                jnp.ones_like(i, jnp.int32),
                dnums,
                indices_are_sorted=True,
                mode=jax.lax.GatherScatterMode.CLIP,
            )
        )
    )
    print(f"hist sorted-scatter   : {timeit(hist_s, (ids,)):7.2f} ms")
    # run-start scatter-min + reverse min-scan alternative
    hist_m = jax.jit(
        lambda i: jax.lax.associative_scan(
            jnp.minimum,
            jnp.full((spec.num_cells + 1,), n, jnp.int32).at[
                jnp.minimum(i, spec.num_cells)
            ].min(jnp.arange(n, dtype=jnp.int32), mode="drop",
                  indices_are_sorted=True),
            reverse=True,
        )
    )
    print(f"hist min-scatter+scan : {timeit(hist_m, (ids,)):7.2f} ms")
    bounds = hist(ids)
    gather = jax.jit(lambda b, q: b[jnp.minimum(q, spec.num_cells)])
    print(f"bounds gather {nq} queries: {timeit(gather, (bounds, q)):7.2f} ms")

    # back-map style gathers
    g1 = jax.jit(lambda a, idx: a[idx])
    idx = p.back_idx
    big = jnp.zeros((block_cap * block,), jnp.float32)
    print(f"back gather (n from {block_cap * block}): "
          f"{timeit(g1, (big, idx)):7.2f} ms")

    srt = jax.jit(lambda s: gridops.sort_state_by_cell(s, spec))
    print(f"sort_state_by_cell    : {timeit(srt, (state,)):7.2f} ms")
    key = jax.jit(
        lambda s: jax.lax.sort_key_val(
            gridops.flat_cell_ids(gridops.cell_coords(s.x, spec), s.material, spec),
            jnp.arange(s.capacity, dtype=jnp.int32),
            is_stable=True,
        )
    )
    print(f"  sort_key_val only   : {timeit(key, (state,)):7.2f} ms")


if __name__ == "__main__":
    main()
