"""Cross-platform lowering gate: AOT-lower every Pallas kernel mode and
step variant for CUDA *from the CPU suite*.

Interpret-mode tests execute the kernel BODIES but never run the Triton
lowering, so a construct that route cannot lower (e.g. the approximate
``pl.reciprocal``: "Unimplemented primitive in Pallas GPU lowering")
passes the whole CPU suite and only fails at the first compile on the
card.  ``jax.jit(...).trace(...).lower(lowering_platforms=("cuda",))``
runs the Pallas-to-Triton lowering without a GPU, so this class of
regression is testable here.  (Triton's own compile to PTX — register and
shared-memory limits — runs only on the card: chip_smoke.py.)
"""

import dataclasses
import json

import jax
import pytest

import tisph as tt
from tisph.models.state import pad_state_capacity
from tisph.ops import grid as gridops
from tisph.ops.neighbors import SweepConfig
from tisph.ops.pallas import sweeps as ps

from test_pallas import _scene

_GPU_KINDS = [k for k in ps.LAUNCH if k != "cpu"]


@pytest.fixture(params=_GPU_KINDS)
def gpu_kind(request, monkeypatch):
    """Lower as if on each tuned device kind (the table lookup is the
    only device query the compiled path makes)."""
    monkeypatch.setattr(ps, "_device_kind", lambda: request.param)
    return request.param


def _lower_cuda(fn, *args):
    jax.jit(fn).trace(*args).lower(lowering_platforms=("cuda",))


def _pallas_solver(scene, cls=tt.WCSPH, cap=2048, **kw):
    solver = cls(
        scene,
        sweep_cfg=SweepConfig(
            impl="pallas", block_size=128, window_cap=512, interpret=False,
            pad_capacity=8192,
        ),
        **kw,
    )
    state = solver.bind(pad_state_capacity(tt.build_state(scene), cap))
    return solver, state


def _body_scene(tmp_path, dynamic):
    from tisph.geometry.mesh import box_mesh, save_obj

    mesh_path = tmp_path / "box.obj"
    save_obj(box_mesh((0.4, 0.6, 0.4), (0.6, 0.8, 0.6)), mesh_path)
    raw = {
        "configuration": {
            "dim": 3, "domainStart": [0.0] * 3, "domainEnd": [1.0] * 3,
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0], "c_s": 40.0,
        },
        "rigidBodies": [
            {"geometryFile": str(mesh_path), "scale": [1, 1, 1],
             "translation": [0, 0, 0], "rotationAngle": 0,
             "rotationAxis": [0, 1, 0], "velocity": [0, 0, 0],
             "density": 500.0, "color": [150, 150, 150],
             "isDynamic": dynamic}
        ],
        "fluidBlocks": [
            {"start": [0.15] * 3, "end": [0.5] * 3,
             "velocity": [0.0, 0.0, 0.0], "density": 1000.0,
             "color": [50, 100, 200]}
        ],
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(raw))
    return tt.load_scene(p)


@pytest.mark.parametrize("dim", [2, 3])
def test_step_lowers_for_cuda(dim, gpu_kind):
    solver, state = _pallas_solver(_scene(dim=dim))
    _lower_cuda(solver._step_fn, state)


@pytest.mark.parametrize("mode", ["density", "force", "bvol", "reaction",
                                  "force_react"])
def test_kernel_mode_lowers_for_cuda(mode, gpu_kind):
    solver, state = _pallas_solver(_scene(dim=3))
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg

    def sweep(st):
        st, ids, _ = gridops.sort_state_by_cell(st, spec)
        plan = gridops.seg_plan(ids, spec, scfg.block_size,
                                scfg.pad_capacity // scfg.block_size)
        meta, _ = ps.seg_block_meta(plan, ids, spec, scfg.block_size,
                                    scfg.window_cap)
        pack = ps.pack_state(st.x, st.v, st.density, st.pressure, st.mass,
                             st.volume, st.material, ids, params)
        active = ps.active_blocks(pack, meta, scfg.block_size)
        return ps._run_sweep_seg(pack, meta, mode, spec, params,
                                 scfg.block_size, False, active=active)

    _lower_cuda(sweep, state)


def test_per_step_boundary_lowers_for_cuda(gpu_kind):
    # bvol sweep (boundary_mode='per_step') rides the same kernel factory
    # but in a distinct mode — lower it too
    solver, state = _pallas_solver(_scene(dim=3), boundary_mode="per_step")
    _lower_cuda(solver._step_fn, state)


def test_rigid_coupled_step_lowers_for_cuda(tmp_path, gpu_kind):
    # the rigid coupled step: bvol + density + fused force_react
    from tisph.models.wcsph_rigid import WCSPHRigid

    solver, state = _pallas_solver(_body_scene(tmp_path, True),
                                   cls=WCSPHRigid)
    rigid = solver.init_rigid(state)
    _lower_cuda(solver._coupled_step_fn, (state, rigid))


def test_static_boundary_skip_step_lowers_for_cuda(tmp_path, gpu_kind):
    # a scene with STATIC boundary particles makes bind set _has_boundary,
    # so the density and force sweeps take per-block active flags
    solver, state = _pallas_solver(_body_scene(tmp_path, False))
    assert solver._has_boundary
    _lower_cuda(solver._step_fn, state)


def test_amortized_group_lowers_for_cuda(gpu_kind):
    # the R-group rollout body (build once, apply R times) is its own
    # traced program — lower the R=2 group
    solver, state = _pallas_solver(_scene(dim=3))
    solver.sweep_cfg = dataclasses.replace(solver.sweep_cfg, resort_every=2)

    def group(s):
        s, cache = solver._seg_build(s)
        s = solver._seg_apply(s, cache)
        return solver._seg_apply(s, cache)

    _lower_cuda(group, state)


@pytest.mark.parametrize("mesh_kind", ["1d", "2x2"])
def test_sharded_step_lowers_for_cuda(mesh_kind, gpu_kind):
    # the 1-D slab mesh and the 2x2 rect mesh over 4 (virtual) devices
    from tisph.parallel import (
        ShardedWCSPH, ShardedWCSPHRect, make_mesh, make_mesh2d,
    )

    scene = _scene(dim=3)
    cfg = SweepConfig(impl="pallas", block_size=128, window_cap=1152,
                      interpret=False)
    if mesh_kind == "1d":
        solver = ShardedWCSPH(scene, make_mesh(4), sweep_cfg=cfg)
    else:
        solver = ShardedWCSPHRect(scene, make_mesh2d(2, 2), sweep_cfg=cfg)
    state = solver.bind(tt.build_state(scene))
    _lower_cuda(solver._step_fn, state)
