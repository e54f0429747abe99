"""Smoke test of the WCSPH step on one GPU, through the entry points a user
calls, at the reference's flagship size.

Phases, all in this one process (one process per card):

1. device: the JAX platform must be ``gpu``; prints the device kind and
   count and the card's name and power limit (nvidia-smi);
2. kernels: every Pallas sweep mode compiled for the card at full width —
   density and force on the bound demo_3d state, bvol, reaction and
   force_react on bench_3d_rigid — against the plain XLA ``blocked`` sweep
   on the same sorted state, each with its time; the step's compiled
   memory analysis;
3. main path: ``WCSPH.run()`` on demo_3d (~195k particles) at the
   amortized cadence R=2 and at R=1, then ``WCSPHRigid.rollout_coupled``
   on bench_3d_rigid (~61k particles), each checked for NaNs, window
   occupancy and a bounded velocity;
4. A/B: warm step times at 195k of the Pallas seg step (R=1 and R=2), the
   XLA ``blocked`` step and the XLA ``gather`` step;
5. the ``gpu``-marked tests (pytest), in this process.

The last line of stdout is one JSON object, printed only when every phase
passed.  ``--devices 4`` runs only the multi-card phase: demo_3d on
``ShardedWCSPH`` over a 1-D mesh and ``ShardedWCSPHRect`` over 2x2,
each against the single-card trajectory with per-particle identity.

    python chip_smoke.py              # one card
    python chip_smoke.py --devices 4  # the meshes, four cards

``--rehearse`` runs the same phases on the CPU at a tiny size with the
kernels in interpret mode (a dry run of the control flow); it never prints
the result line and exits 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import tisph as tt  # noqa: E402
from tisph.models.wcsph_rigid import WCSPHRigid  # noqa: E402
from tisph.ops import forces as F  # noqa: E402
from tisph.ops import grid as gridops  # noqa: E402
from tisph.ops.neighbors import SweepConfig  # noqa: E402
from tisph.ops.pallas import sweeps as ps  # noqa: E402
from tisph.utils.compile_cache import use_compile_cache  # noqa: E402

# Tolerances of the compiled kernels against the XLA blocked sweep on the
# same state.  Both sum the same pairs in f32; only the summation order
# and the distance evaluation differ (the kernel takes rsqrt, the blocked
# sweep sqrt, each within 2 ulp), and every divide is exact in both.
DENSITY_RTOL = 1e-5   # relative, per fluid row
VOLUME_RTOL = 1e-5    # relative, per boundary row (1 / delta)
VECTOR_TOL = 1e-4     # of the largest |value| (force, reaction)
MESH_TOL_H = 0.02     # sharded vs single-card: max |dx| over h, 20 steps

REHEARSE = False


def log(*args):
    print(*args, flush=True)


def scene_path(name):
    return os.path.join(ROOT, "scenes", name)


def load_scene(name, body_y=None):
    """The scene as users run it; on a rehearsal 5x the particle radius
    (1/125 of the particles in 3-D).  ``body_y`` moves the rigid body's
    centre to that height."""
    if not REHEARSE and body_y is None:
        return tt.load_scene(scene_path(name))
    with open(scene_path(name)) as f:
        raw = json.load(f)
    if REHEARSE:
        raw["configuration"]["particleRadius"] *= 5.0
    for rb in raw.get("rigidBodies", []):
        rb["geometryFile"] = os.path.join(ROOT, "scenes", rb["geometryFile"])
        if body_y is not None:
            rb["translation"][1] = body_y
    return tt.scene_from_dict(raw)


def _rel(a, b):
    """max |a - b| over max |b|; the reference must not be all zeros."""
    scale = float(np.max(np.abs(b)))
    if not scale > 0:
        raise SystemExit("kernel check: the reference is all zeros")
    return float(np.max(np.abs(a - b))) / scale


def sweep_cfg(**kw):
    """Auto-selection on the card; an explicit interpret-mode Pallas
    config on a rehearsal (the CPU default is the blocked sweep)."""
    if not REHEARSE:
        return None
    return SweepConfig(impl="pallas", interpret=True, **kw)


def set_resort(solver, r):
    solver.sweep_cfg = dataclasses.replace(solver.sweep_cfg, resort_every=r)
    for name in [k for k in vars(solver) if k.endswith("_jit")]:
        setattr(solver, name, None)


def timed(fn, *args, reps=3):
    """Mean seconds per call over ``reps`` warm calls (one warm-up call
    compiles outside the window)."""
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------
def phase_device(n_devices):
    devs = jax.devices()
    if devs[0].platform != "gpu" and not REHEARSE:
        raise SystemExit(f"no GPU: JAX's platform is {devs[0].platform!r}")
    if len(devs) < n_devices:
        raise SystemExit(f"need {n_devices} devices, JAX has {len(devs)}")
    log(f"device: platform={devs[0].platform} kind={devs[0].device_kind!r} "
        f"count={len(devs)}")
    if REHEARSE:
        return "cpu (rehearsal)"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(f"card: {card[0]}")
    return card[0]


# ---------------------------------------------------------------------------
# 2. kernels vs the XLA blocked sweep
# ---------------------------------------------------------------------------
def _structures(solver, state):
    """Sorted state, the seg meta + pack the kernels read, and the blocked
    sweep's neighbor data, built once on the card."""
    spec, params, cfg = solver.spec, solver.params, solver.sweep_cfg
    block = cfg.block_size
    _, window, _ = gridops.measure_caps_device(state, spec, 128)
    cfg_b = SweepConfig(impl="blocked", block_size=128,
                        window_cap=int(-(-(window * 1.25) // 128) * 128))

    @jax.jit
    def build(st):
        st, ids, _ = gridops.sort_state_by_cell(st, spec)
        plan = gridops.seg_plan(ids, spec, block, cfg.pad_capacity // block)
        meta, _ = ps.seg_block_meta(plan, ids, spec, block, cfg.window_cap)
        pack = ps.pack_state(st.x, st.v, st.density, st.pressure, st.mass,
                             st.volume, st.material, ids, params)
        nd = gridops.build_neighbor_data(st, ids, spec, cfg_b)
        return st, meta, pack, nd, plan.back_valid

    return build(state) + (cfg_b,)


def _run_kernel(mode, solver, pack, meta):
    """(output, warm seconds per call) of one kernel mode compiled for the
    card."""
    spec, params, cfg = solver.spec, solver.params, solver.sweep_cfg
    fn = jax.jit(lambda pk, m: ps._run_sweep_seg(
        pk, m, mode, spec, params, cfg.block_size, cfg.interpret))
    return np.asarray(fn(pack, meta)), timed(fn, pack, meta, reps=20)


def _check(name, err, tol, t_kernel, t_blocked):
    ok = bool(np.isfinite(err)) and err <= tol
    log(f"kernel {name:11s}: max err {err:.3e} (tol {tol:.0e})  "
        f"pallas {t_kernel * 1e3:9.3f} ms  xla-blocked {t_blocked * 1e3:9.3f} ms"
        f"  {'ok' if ok else 'FAIL'}")
    return ok


def phase_kernels():
    ok = True
    # -- density + force on the flagship state --
    scene = load_scene("demo_3d.json")
    solver = tt.WCSPH(scene, sweep_cfg=sweep_cfg())
    state = solver.bind(tt.build_state(scene))
    assert solver.sweep_cfg.impl == "pallas", solver.sweep_cfg
    spec, params = solver.spec, solver.params
    log(f"demo_3d: {int(state.num_active)} particles, window_cap "
        f"{solver.sweep_cfg.window_cap}, blocks "
        f"{solver.sweep_cfg.pad_capacity // solver.sweep_cfg.block_size}, "
        f"launch {ps.launch_config('force', solver.sweep_cfg.interpret)}")
    st, meta, pack, nd, valid, cfg_b = _structures(solver, state)
    fluid = np.asarray(valid & st.fluid_mask)

    dens_b = jax.jit(lambda s, n: F.compute_densities(s, n, spec, params, cfg_b))
    rho_b = dens_b(st, nd)
    rho_k, t_k = _run_kernel("density", solver, pack, meta)
    rk, rb = rho_k[0][fluid], np.asarray(rho_b)[fluid]
    ok &= _check("density", float(np.max(np.abs(rk / rb - 1.0))), DENSITY_RTOL,
                 t_k, timed(dens_b, st, nd, reps=1))

    rho, p = F.compute_pressures(rho_b, params)
    st = dataclasses.replace(st, density=rho, pressure=p)
    pack = ps.repack_eos(pack, rho, p)
    force_b = jax.jit(lambda s, n: F.compute_forces(s, n, spec, params, cfg_b))
    dv_b = np.asarray(force_b(st, nd))[fluid]
    dv_k, t_k = _run_kernel("force", solver, pack, meta)
    ok &= _check("force", _rel(dv_k.T[fluid], dv_b), VECTOR_TOL, t_k,
                 timed(force_b, st, nd, reps=1))

    step = jax.jit(solver._step_fn).lower(state).compile()
    log(f"step memory analysis (demo_3d): {step.memory_analysis()}")

    # -- the boundary modes on the rigid scene, the body lowered from its
    # drop height into the free surface (0.6 m) so that it has fluid
    # neighbours --
    scene = load_scene("bench_3d_rigid.json", body_y=0.6)
    solver = WCSPHRigid(scene, sweep_cfg=sweep_cfg())
    state = solver.bind(tt.build_state(scene))
    spec, params = solver.spec, solver.params
    log(f"bench_3d_rigid: {int(state.num_active)} particles")
    st, meta, pack, nd, valid, cfg_b = _structures(solver, state)
    bound = np.asarray(valid & st.boundary_mask)
    fluid = np.asarray(valid & st.fluid_mask)

    vol_b = jax.jit(lambda s, n: F.compute_boundary_volumes(s, n, spec, params, cfg_b))
    vb = np.asarray(vol_b(st, nd))[bound]
    delta, t_k = _run_kernel("bvol", solver, pack, meta)
    ok &= _check("bvol", float(np.max(np.abs(1.0 / (delta[0][bound] * vb) - 1.0))),
                 VOLUME_RTOL, t_k, timed(vol_b, st, nd, reps=1))

    rho = F.compute_densities(st, nd, spec, params, cfg_b)
    rho, p = F.compute_pressures(rho, params)
    st = dataclasses.replace(st, density=rho, pressure=p)
    pack = ps.repack_eos(pack, rho, p)
    react_b = jax.jit(lambda s, n: F.compute_rigid_reactions(s, n, spec, params, cfg_b))
    rx_b = np.asarray(react_b(st, nd))[bound]
    rx_k, t_k = _run_kernel("reaction", solver, pack, meta)
    ok &= _check("reaction", _rel(rx_k.T[bound], rx_b), VECTOR_TOL, t_k,
                 timed(react_b, st, nd, reps=1))

    dv_b = np.asarray(F.compute_forces(st, nd, spec, params, cfg_b))[fluid]
    fr, t_k = _run_kernel("force_react", solver, pack, meta)
    err = max(_rel(fr.T[fluid], dv_b), _rel(fr.T[bound], rx_b))
    ok &= _check("force_react", err, VECTOR_TOL, t_k, float("nan"))
    if not ok:
        raise SystemExit("kernel phase failed")


# ---------------------------------------------------------------------------
# 3. the main path
# ---------------------------------------------------------------------------
def _health(name, solver, state):
    m = jax.device_get(solver.metrics(state))
    vmax = float(m["max_velocity"])
    # weak compressibility holds only while |v| stays under the numerical
    # speed of sound; a blow-up passes it
    bound = solver.params.c_s
    log(f"{name}: vmax={vmax:.3f} m/s (bound c_s={bound}) "
        f"cfl={float(m['cfl']):.3f} rho_err={float(m['avg_density_error']):.4f} "
        f"window={int(m['max_run_length'])}/{int(m['run_cap'])} "
        f"nan={int(m['nan_count'])}")
    if int(m["nan_count"]) or not np.isfinite(vmax):
        raise SystemExit(f"{name}: NaN in the state")
    if int(m["max_run_length"]) > int(m["run_cap"]):
        raise SystemExit(f"{name}: window occupancy over its cap")
    if vmax > bound and not REHEARSE:  # coarse rehearsal: no bound
        raise SystemExit(f"{name}: vmax {vmax} over c_s = {bound} m/s")


def phase_main(steps, rigid_steps):
    scene = load_scene("demo_3d.json")
    solver = tt.WCSPH(scene, sweep_cfg=sweep_cfg())
    state = solver.bind(tt.build_state(scene))
    for r in (2, 1):
        set_resort(solver, r)
        t0 = time.perf_counter()
        state = solver.run(state, steps)
        jax.block_until_ready(state.x)
        log(f"demo_3d run() {steps} steps at R={r}: "
            f"{time.perf_counter() - t0:.1f} s wall (compile included)")
        _health(f"demo_3d R={r}", solver, state)

    scene = load_scene("bench_3d_rigid.json")
    solver = WCSPHRigid(scene, sweep_cfg=sweep_cfg())
    state = solver.bind(tt.build_state(scene))
    rigid = solver.init_rigid(state)
    state, rigid = solver.rollout_coupled(state, rigid, rigid_steps)
    _health(f"bench_3d_rigid {rigid_steps} coupled steps", solver, state)
    com = np.asarray(rigid.com)
    lo, hi = np.asarray(scene.domain_start), np.asarray(scene.domain_end)
    log(f"body com: {com.tolist()}")
    if not (np.isfinite(com).all() and (com > lo).all() and (com < hi).all()):
        raise SystemExit("rigid body left the domain")


# ---------------------------------------------------------------------------
# 4. A/B of the sweep paths, end to end
# ---------------------------------------------------------------------------
def _step_time(solver, state, steps):
    """Warm seconds per step: one rollout of ``steps`` compiles and warms
    (the state advances through it), the next is timed."""
    state = solver.rollout(state, steps)
    jax.block_until_ready(state.x)
    t0 = time.perf_counter()
    state = solver.rollout(state, steps)
    jax.block_until_ready(state.x)
    dt = (time.perf_counter() - t0) / steps
    m = jax.device_get(solver.metrics(state))
    if int(m["nan_count"]):
        raise SystemExit("A/B: NaN in the state")
    # the relaxing lattice sheds neighbours: the density error says how
    # dense the timed window's end state is
    return dt, float(m["avg_density_error"])


def phase_ab(card, steps, xla_steps):
    scene = load_scene("demo_3d.json")
    state0 = tt.build_state(scene)
    n = int(state0.num_active)
    rows = []
    solver = tt.WCSPH(scene, sweep_cfg=sweep_cfg())
    state = solver.bind(state0)
    for r in (1, 2):
        set_resort(solver, r)
        rows.append((f"pallas-seg R={r}", _step_time(solver, state, steps)))

    run_len, window, _ = gridops.measure_caps_device(state0, solver.spec, 128)
    for impl, kw in (("blocked", {"window_cap": int(-(-(window * 1.5) // 128) * 128)}),
                     ("gather", {"chunk_size": 32768})):
        s = tt.WCSPH(scene, sweep_cfg=SweepConfig(impl=impl, block_size=128, **kw))
        rows.append((f"xla-{impl} R=1", _step_time(s, s.bind(state0), xla_steps)))

    ids = jax.jit(lambda st: gridops.sort_state_by_cell(st, solver.spec)[1])(state)
    for name, fn in (("searchsorted", gridops.csr_bounds),
                     ("hist", gridops.csr_bounds_hist)):
        t = timed(jax.jit(lambda i, fn=fn: fn(i, solver.spec)), ids, reps=10)
        log(f"csr bounds {name:12s}: {t * 1e3:.3f} ms")
    for name, (dt, rho_err) in rows:
        log(f"ab: {name:16s} {dt * 1e3:10.3f} ms/step  {n / dt:.4e} "
            f"particle-steps/s  rho_err {rho_err:.4f}  ({n} particles; "
            f"card: {card})")
    best_xla = min(dt for name, (dt, _) in rows if name.startswith("xla"))
    if rows[0][1][0] >= best_xla and not REHEARSE:
        raise SystemExit("the Pallas seg step does not beat the XLA paths")


# ---------------------------------------------------------------------------
# 5. card-only tests
# ---------------------------------------------------------------------------
def phase_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests")])
    if rc != 0:
        raise SystemExit(f"gpu tests failed (pytest exit {rc})")


# ---------------------------------------------------------------------------
# --devices 4: the meshes against the single card
# ---------------------------------------------------------------------------
def phase_mesh(n_devices, steps):
    from tisph.parallel import (
        ShardedWCSPH, ShardedWCSPHRect, make_mesh, make_mesh2d,
    )

    scene = load_scene("demo_3d.json")
    state0 = tt.build_state(scene)
    state0 = dataclasses.replace(
        state0, object_id=jnp.arange(state0.capacity, dtype=jnp.int32))

    def positions(solver):
        st = solver.bind(state0)
        for _ in range(steps):
            st = solver.step(st)
        st = jax.device_get(st)
        act = np.asarray(st.material) != tt.MATERIAL_INVALID
        oid = np.asarray(st.object_id)[act]
        x = np.asarray(st.x)[act][np.argsort(oid)]
        return np.sort(oid), x

    h = scene.support_length
    oid1, x1 = positions(tt.WCSPH(scene, sweep_cfg=sweep_cfg()))
    side = int(round(n_devices ** 0.5))
    for name, solver in (
        (f"1-D {n_devices}", ShardedWCSPH(scene, make_mesh(n_devices),
                                          sweep_cfg=sweep_cfg())),
        (f"{side}x{side}", ShardedWCSPHRect(scene, make_mesh2d(side, side),
                                            sweep_cfg=sweep_cfg())),
    ):
        t0 = time.perf_counter()
        oid, x = positions(solver)
        if not np.array_equal(oid, oid1):
            raise SystemExit(f"mesh {name}: particle identities differ")
        d = np.linalg.norm(x - x1, axis=-1) / h
        log(f"mesh {name}: {steps} steps, max |dx|/h {d.max():.3e}, p99 "
            f"{np.quantile(d, 0.99):.3e} (tol {MESH_TOL_H}), "
            f"{time.perf_counter() - t0:.1f} s wall (compile included)")
        if not d.max() <= MESH_TOL_H:
            raise SystemExit(f"mesh {name}: trajectory off the single card")


def main() -> int:
    global REHEARSE
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-card mesh phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="dry run on the CPU at a tiny size (exits 3)")
    args = ap.parse_args()
    REHEARSE = args.rehearse
    use_compile_cache()

    card = phase_device(args.devices)
    if args.devices > 1:
        phase_mesh(args.devices, steps=20)
    else:
        phase_kernels()
        phase_main(steps=20 if REHEARSE else 200,
                   rigid_steps=10 if REHEARSE else 50)
        phase_ab(card, steps=5 if REHEARSE else 100,
                 xla_steps=2 if REHEARSE else 5)
        if not REHEARSE:
            phase_tests()
    if REHEARSE:
        log("rehearsal complete (no result line)")
        return 3
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
