"""Tune the seg sweeps' launch geometry on the card.

Times the density (scalar family) and force (vector family) Pallas
kernels on the bound demo_3d state over a grid of (i lanes per program,
j-tile width, warps, pipeline stages), checks every geometry's output
against the first one, and prints the fastest per family — the entries
to keep in ``tisph.ops.pallas.sweeps.LAUNCH`` for this device kind.

    python tools/tune_seg_launch.py [scene.json]
"""

from __future__ import annotations

import itertools
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import tisph as tt  # noqa: E402
from tisph.ops import forces as F  # noqa: E402
from tisph.ops import grid as gridops  # noqa: E402
from tisph.ops.pallas import sweeps as ps  # noqa: E402

GRID = {
    "bi": (16, 32, 64),
    "tile": (16, 32, 64),
    "num_warps": (4, 8, 16),
    "num_stages": (3,),
}


def main() -> int:
    scene_file = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "scenes", "demo_3d.json")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX's platform is {dev.platform!r}")
    kind = dev.device_kind
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device kind {kind!r}; card: {card}", flush=True)
    ps.LAUNCH.setdefault(kind, dict(ps.LAUNCH["cpu"]))

    scene = tt.load_scene(scene_file)
    solver = tt.WCSPH(scene)
    state = solver.bind(tt.build_state(scene))
    spec, params, cfg = solver.spec, solver.params, solver.sweep_cfg
    block = cfg.block_size

    @jax.jit
    def build(st):
        st, ids, _ = gridops.sort_state_by_cell(st, spec)
        plan = gridops.seg_plan(ids, spec, block, cfg.pad_capacity // block)
        meta, _ = ps.seg_block_meta(plan, ids, spec, block, cfg.window_cap)
        pack = ps.pack_state(st.x, st.v, st.density, st.pressure, st.mass,
                             st.volume, st.material, ids, params)
        return meta, pack, plan.back_valid

    meta, pack, valid = build(state)
    rho = ps.density_sweep_seg(pack, meta, spec, params, block)
    rho, p = F.compute_pressures(rho, params)
    pack = ps.repack_eos(pack, rho, p)
    valid = np.asarray(valid)
    print(f"{int(state.num_active)} particles, window_cap {cfg.window_cap}, "
          f"{meta.iblk.shape[0]} blocks", flush=True)

    for family, mode in (("scalar", "density"), ("vector", "force")):
        results, ref = [], None
        for geom in itertools.product(*GRID.values()):
            if geom[0] > block:
                continue
            ps.LAUNCH[kind] = dict(ps.LAUNCH[kind], **{family: geom})
            fn = jax.jit(lambda pk, m: ps._run_sweep_seg(
                pk, m, mode, spec, params, block, False))
            try:
                out = np.asarray(fn(pack, meta))[:, valid]
            except Exception as e:  # a geometry the compiler refuses
                print(f"{mode} {geom}: {type(e).__name__}: {str(e)[:120]}")
                continue
            if ref is None:
                ref = out
            err = float(np.max(np.abs(out - ref)) / np.max(np.abs(ref)))
            t0 = time.perf_counter()
            for _ in range(10):
                o = fn(pack, meta)
            jax.block_until_ready(o)
            ms = (time.perf_counter() - t0) / 10 * 1e3
            results.append((ms, geom, err))
            print(f"{mode} bi={geom[0]:3d} tile={geom[1]:3d} warps={geom[2]} "
                  f"stages={geom[3]}: {ms:8.3f} ms  (err {err:.1e})",
                  flush=True)
        results.sort()
        print(f"best {family} ({mode}): {results[0][1]} at "
              f"{results[0][0]:.3f} ms; top 5: "
              + "; ".join(f"{g} {m:.3f}" for m, g, _ in results[:5]),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
