"""Programmatic API demo — no scene file (reference demo.py:10-25: direct
``ps.add_cube`` + WCSPH + GUI loop).  Builds a 2D dam break purely in code
and renders PNG frames with the viewer.

Usage: python examples/demo.py [--frames 60] [--out /tmp/demo_frames]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import tisph as tt
from tisph.config import FluidBlock, SceneConfig
from tisph.render.viewer import Viewer


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--substeps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    # Scene built in code — the reference's demo.py path (add_cube direct).
    scene = SceneConfig(
        dim=2,
        domain_start=(0.0, 0.0),
        domain_end=(3.0, 2.0),
        particle_radius=0.01,
        gravitation=(0.0, -9.81),
        c_s=60.0,
        fluid_blocks=(
            FluidBlock(start=(0.2, 0.1), end=(0.8, 1.2), velocity=(0.0, -2.0)),
            FluidBlock(start=(2.2, 0.1), end=(2.8, 0.7), velocity=(-1.0, 0.0),
                       color=(0.9, 0.4, 0.2)),
        ),
    )
    state = tt.build_state(scene)
    solver = tt.WCSPH(scene)
    state = solver.bind(state)
    print(f"{int(state.num_active)} particles, sweep={solver.sweep_cfg.impl}")

    viewer = Viewer(scene, interactive=args.out is None)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for frame in range(args.frames):
        state = solver.rollout(state, args.substeps)
        viewer.show(state, title=f"frame {frame}")
        if args.out:
            viewer.savefig(os.path.join(args.out, f"demo_{frame:05d}.png"))
    viewer.close()
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
