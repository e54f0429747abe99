"""Run a scene file — the framework's equivalent of the reference's entry
scripts (main.py / main_3d.py), but headless and CLI-driven (the reference
hardcodes scene paths and has no argparse, SURVEY.md §5.6).

Usage:
    python examples/run_scene.py scenes/demo_2d.json --steps 200 \
        --substeps 5 --out /tmp/frames --format npz
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import tisph as tt
from tisph.models.state import state_to_host
from tisph.utils.compile_cache import use_compile_cache


def main() -> int:
    ap = argparse.ArgumentParser(description="Run a tisph scene")
    ap.add_argument("scene", help="scene JSON (reference schema)")
    ap.add_argument("--steps", type=int, default=100, help="rendered frames")
    ap.add_argument("--substeps", type=int, default=5,
                    help="solver steps per frame (reference runs 5, main_3d.py:31)")
    ap.add_argument("--solver", choices=["wcsph", "legacy"], default="wcsph")
    ap.add_argument("--compat",
                    choices=["reference", "config", "reference-exact"],
                    default="reference",
                    help="'reference' = intended equations with the "
                         "reference's constants; 'config' honors scene keys "
                         "the reference ignores; 'reference-exact' replays "
                         "the reference's shipped bugs (zero pressure in V2, "
                         "no V1 domain clamp) for divergence measurement")
    ap.add_argument("--out", default=None, help="frame output directory")
    ap.add_argument("--format", choices=["npz", "png"], default="npz")
    ap.add_argument("--metrics-every", type=int, default=10)
    ap.add_argument("--bpa", action="store_true",
                    help="2D scenes: extract the fluid boundary with ball "
                         "pivoting on the final frame and save it as *.bpa.npz")
    ap.add_argument("--checkpoint", default=None,
                    help="write a full-state checkpoint here at the end")
    ap.add_argument("--resume", default=None,
                    help="resume from a checkpoint written by --checkpoint")
    ap.add_argument("--view", action="store_true",
                    help="live matplotlib window updated as frames complete "
                         "(the reference's ti.GUI loop, main.py:16-24; falls "
                         "back to headless Agg snapshots without a display)")
    ap.add_argument("--orbit", action="store_true",
                    help="3D scenes: interactive orbit-camera viewer (the "
                         "reference's GGUI window, main_3d.py:8-46 — "
                         "left-drag orbit, right-drag pan, scroll dolly, "
                         "wasd/qe move, r reset); implies --view")
    ap.add_argument("--view-every", type=int, default=1,
                    help="with --view: redraw every N frames")
    ap.add_argument("--gif", default=None,
                    help="assemble exported PNG frames into a GIF here "
                         "(requires --out and --format png)")
    ap.add_argument("--resort", type=int, default=1,
                    help="pallas sweeps: rebuild the neighbor structure "
                         "every N substeps (amortized resort; N=1 is the "
                         "reference's exact per-substep cadence — see "
                         "ROADMAP.md for the measured divergence)")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (same as JAX_PLATFORMS=cpu)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    use_compile_cache()
    if args.gif and (not args.out or args.format != "png"):
        ap.error("--gif requires --out DIR and --format png")

    scene = tt.load_scene(args.scene)
    print(f"scene: dim={scene.dim} domain={scene.domain_start}->{scene.domain_end} "
          f"r={scene.particle_radius}")
    state = tt.build_state(scene)
    print(f"particles: {int(state.num_active)} (capacity {state.capacity})")

    rigid = None
    if args.solver == "wcsph" and any(rb.is_dynamic for rb in scene.rigid_bodies):
        from tisph.models.wcsph_rigid import WCSPHRigid
        solver = WCSPHRigid(scene, compat=args.compat)
        state = solver.bind(state)
        rigid = solver.init_rigid(state)
        print(f"dynamic rigid bodies: {rigid.num_bodies}")
    else:
        solver_cls = tt.WCSPH if args.solver == "wcsph" else tt.WCSPHLegacy
        solver = solver_cls(scene, compat=args.compat)
        state = solver.bind(state)
    emitters_ck = []
    if args.resume:
        from tisph import checkpoint
        state, rigid_ck, emitters_ck = checkpoint.load_npz(
            args.resume, with_rigid=True, with_emitters=True
        )
        if rigid_ck is not None:
            rigid = rigid_ck  # body momentum is not derivable from particles
        print(f"resumed from {args.resume}: {int(state.num_active)} particles"
              + (" + rigid body state" if rigid_ck is not None else "")
              + (f" + {len(emitters_ck)} emitter state(s)" if emitters_ck
                 else ""))
    if args.resort > 1:
        if solver.sweep_cfg is not None and solver.sweep_cfg.impl == "pallas":
            import dataclasses as _dc
            solver.sweep_cfg = _dc.replace(
                solver.sweep_cfg, resort_every=args.resort
            )
        else:
            print("warning: --resort applies only to the pallas sweep "
                  f"path (active: {solver.sweep_cfg.impl})", file=sys.stderr)
    print(f"grid: res={solver.spec.res} run_cap={solver.spec.run_cap} "
          f"dt={solver.params.dt} sweep={solver.sweep_cfg.impl}")

    emitters = []
    if scene.emitters:
        from tisph.geometry.emitter import make_emitter_state
        emitters = [make_emitter_state(em, scene) for em in scene.emitters]
        if emitters_ck:
            # resume the interval counters / emitted totals; a fresh
            # make_emitter_state would reset the emission cadence
            emitters = emitters_ck
        print(f"emitters: {len(emitters)} "
              f"(batch sizes {[e.batch_size for e in emitters]})")

    exporter = None
    if args.out:
        from tisph.render.export import FrameExporter
        exporter = FrameExporter(args.out, fmt=args.format, scene=scene)

    viewer = None
    if args.orbit and scene.dim == 3:
        from tisph.render.orbit import OrbitViewer
        viewer = OrbitViewer(scene, interactive=True)
    elif args.view or args.orbit:
        if args.orbit:
            print("warning: --orbit is 3D-only; using the flat viewer",
                  file=sys.stderr)
        from tisph.render.viewer import Viewer
        viewer = Viewer(scene, interactive=True)

    t0 = time.time()
    for frame in range(args.steps):
        if rigid is not None:
            state, rigid = solver.rollout_coupled(state, rigid, args.substeps)
        elif emitters:
            state, emitters = solver.rollout_emit(state, emitters, args.substeps)
        else:
            state = solver.rollout(state, args.substeps)
        if exporter is not None:
            exporter.save(state, frame)
        if viewer is not None and frame % args.view_every == 0:
            viewer.show(state, title=f"frame {frame}")
        if args.metrics_every and frame % args.metrics_every == 0:
            m = jax.device_get(solver.metrics(state))
            print(f"frame {frame:5d}  vmax={float(m['max_velocity']):8.3f}  "
                  f"cfl={float(m['cfl']):6.4f}  "
                  f"rho_err={float(m['avg_density_error']):7.4f}  "
                  f"run={int(m['max_run_length'])}/{int(m['run_cap'])}  "
                  f"nan={int(m['nan_count'])}")
            if int(m["nan_count"]):
                print("ERROR: NaN detected, aborting", file=sys.stderr)
                return 1
            if int(m["max_run_length"]) > int(m["run_cap"]):
                solver.regrow(int(int(m["max_run_length"]) * 1.5))
                print(f"note: window occupancy {int(m['max_run_length'])} "
                      f"exceeded cap; re-capacitated to "
                      f"{solver.sweep_cfg.window_cap} (recompile)")
    jax.block_until_ready(state.x)
    wall = time.time() - t0
    total_steps = args.steps * args.substeps
    pps = int(state.num_active) * total_steps / wall
    print(f"done: {total_steps} steps, {wall:.2f}s wall, "
          f"{pps:.3e} particle-steps/sec")
    if viewer is not None:
        viewer.close()
    if exporter is not None:
        exporter.close()
        print(f"frames written to {args.out}")
    if args.gif:
        from tisph.render.video import frames_to_gif
        print(f"GIF written to {frames_to_gif(args.out, args.gif)}")
    if args.checkpoint:
        from tisph import checkpoint
        checkpoint.save_npz(state, args.checkpoint, rigid=rigid,
                            emitters=emitters)
        print(f"checkpoint written to {args.checkpoint}")
    if args.bpa:
        import numpy as np
        from tisph.models.state import state_to_host
        from tisph.render.bpa2d import extract_boundary_2d
        host = state_to_host(state)
        fluid = host["material"] == 1
        pts = host["x"][fluid][:, :2]
        b = extract_boundary_2d(pts, radius=3.0 * scene.particle_radius)
        out = (args.out or ".") + "/boundary.bpa.npz"
        np.savez_compressed(
            out, points=b.points, edges=b.edges,
            loop_sizes=np.asarray([len(l) for l in b.loops]),
            loops=np.concatenate(b.loops) if b.loops else np.zeros(0, np.int64),
        )
        print(f"BPA boundary: {len(b.loops)} loops, {b.edges.shape[0]} edges "
              f"-> {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
