"""Seg layout (grid.seg_plan + the Triton-route Pallas row-confined
logical-block sweeps, in interpret mode on the CPU): the layout is a pure
re-indexing of the compact sorted array, so sweep outputs must match the
jnp blocked sweep / brute force on the identical state, and the plan
itself must be a consistent block partition."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tisph as tt

_INTERPRET = True
from tisph.models.state import pad_state_capacity
from tisph.ops import forces as F
from tisph.ops import grid as gridops
from tisph.ops.kernels import cubic_kernel
from tisph.ops.neighbors import SweepConfig
from tisph.ops.pallas import sweeps as ps

from test_pallas import _scene


def _seg_setup(scene, cap=2048, pad_cap=8192, block=128, wcap=512):
    state = tt.build_state(scene)
    solver = tt.WCSPH(
        scene,
        sweep_cfg=SweepConfig(impl="pallas", block_size=block, window_cap=wcap,
                              interpret=_INTERPRET, pad_capacity=pad_cap),
    )
    state = solver.bind(pad_state_capacity(state, cap))
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg
    state_s, ids, _ = gridops.sort_state_by_cell(state, spec)
    plan = gridops.seg_plan(ids, spec, scfg.block_size,
                            scfg.pad_capacity // scfg.block_size)
    meta, _ = ps.seg_block_meta(
        plan, ids, spec, scfg.block_size, scfg.window_cap
    )
    pack = ps.pack_state(
        state_s.x, state_s.v, state_s.density, state_s.pressure,
        state_s.mass, state_s.volume, state_s.material, ids, params,
    )
    return solver, state_s, ids, plan, meta, pack


@pytest.mark.parametrize("dim", [2, 3])
def test_seg_plan_is_consistent(dim):
    scene = _scene(dim=dim)
    solver, state_s, ids, plan, _, _ = _seg_setup(scene)
    spec = solver.spec
    block = solver.sweep_cfg.block_size
    ids_np = np.asarray(ids)
    res_z = spec.res[-1]
    n = ids_np.shape[0]
    act = ids_np < spec.num_cells

    seg_start = np.asarray(plan.seg_start)
    seg_len = np.asarray(plan.seg_len)
    own_lo = np.asarray(plan.own_lo)
    id_first = np.asarray(plan.id_first)
    id_last = np.asarray(plan.id_last)
    back = np.asarray(plan.back_idx)
    back_valid = np.asarray(plan.back_valid)

    # starts are block-aligned (SegMeta.iblk is in block units)
    assert (seg_start % block == 0).all()

    # every active particle maps to a slot whose block agrees on position
    # and own id range; slots are unique (no two particles share one)
    assert back_valid[act].all() and not back_valid[~act].any()
    assert len(np.unique(back[act])) == act.sum()
    for t in np.nonzero(act)[0][:: max(1, n // 300)]:
        b, lane = back[t] // block, back[t] % block
        assert seg_start[b] + lane == t
        assert seg_len[b] > 0
        assert own_lo[b] <= lane < own_lo[b] + seg_len[b]
        assert id_first[b] <= ids_np[t] <= id_last[b]


@pytest.mark.parametrize("dim", [2, 3])
def test_seg_density_matches_bruteforce(dim):
    scene = _scene(dim=dim)
    solver, state_s, ids, plan, meta, pack = _seg_setup(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg

    rho_blk = ps.density_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=_INTERPRET,
    )
    # compact kernel output: valid where plan.back_valid (all active
    # lanes here, asserted by test_seg_plan_roundtrip)
    rho_p = np.asarray(rho_blk)

    x = np.asarray(state_s.x, dtype=np.float64)
    act = np.asarray(state_s.material) != -1
    h = params.support_length
    m = np.asarray(state_s.mass)
    n = x.shape[0]
    d = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
    nb = (d < h) & ~np.eye(n, dtype=bool) & act[None, :] & act[:, None]
    w = np.asarray(
        cubic_kernel(jnp.asarray(d.reshape(-1), jnp.float32), h, dim)
    ).reshape(n, n)
    w0 = float(cubic_kernel(jnp.zeros(()), h, dim))
    rho_brute = m * w0 + (w * nb * m[None, :]).sum(1)

    fluid = np.asarray(state_s.material) == 1
    np.testing.assert_allclose(rho_p[fluid], rho_brute[fluid], rtol=2e-5)


def _rigid_scene(tmp_path):
    """Fluid block beside a box body: boundary rows for the bvol /
    reaction / force_react modes and the boundary-aware block skip."""
    from tisph.geometry.mesh import box_mesh, save_obj

    mesh_path = tmp_path / "box.obj"
    save_obj(box_mesh((0.35, 0.5, 0.35), (0.6, 0.75, 0.6)), mesh_path)
    return tt.scene_from_dict({
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
             "isDynamic": True}
        ],
        "fluidBlocks": [
            {"start": [0.15] * 3, "end": [0.6, 0.55, 0.6],
             "velocity": [0.1, -0.4, 0.2], "density": 1000.0,
             "color": [50, 100, 200]}
        ],
    })


@pytest.mark.parametrize("mode", ["bvol", "reaction"])
def test_seg_boundary_modes_match_blocked(mode, tmp_path):
    """The boundary-volume denominator and the fluid->boundary reaction
    force (the rigid coupling's modes) against the jnp blocked sweeps on
    the identical sorted state, on every consumed boundary row."""
    scene = _rigid_scene(tmp_path)
    solver, state_s, ids, plan, meta, pack = _seg_setup(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg
    scfg_b = SweepConfig(impl="blocked", block_size=128, window_cap=2048)
    nd = gridops.build_neighbor_data(state_s, ids, spec, scfg_b)
    keep = np.asarray(plan.back_valid) & (np.asarray(state_s.material) == 0)
    assert keep.any()
    if mode == "bvol":
        ref = np.asarray(
            F.compute_boundary_volumes(state_s, nd, spec, params, scfg_b))
        delta = np.asarray(ps.bvol_sweep_seg(
            pack, meta, spec, params, scfg.block_size, interpret=_INTERPRET))
        np.testing.assert_allclose(1.0 / delta[keep], ref[keep], rtol=2e-5)
        return
    rho = F.compute_densities(state_s, nd, spec, params, scfg_b)
    rho, p = F.compute_pressures(rho, params)
    state_s = dataclasses.replace(state_s, density=rho, pressure=p)
    pack = ps.repack_eos(pack, rho, p)
    ref = np.asarray(
        F.compute_rigid_reactions(state_s, nd, spec, params, scfg_b))
    out = np.asarray(ps.reaction_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=_INTERPRET))
    scale = np.abs(ref[keep]).max()
    assert scale > 0
    np.testing.assert_allclose(out[keep] / scale, ref[keep] / scale,
                               atol=5e-6)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("bi,tile", [(16, 32), (64, 16), (128, 64)])
def test_seg_launch_geometry_is_a_retiling(dim, bi, tile, monkeypatch):
    """The launch geometry (i lanes per program, j-tile width; tuned per
    device kind in ps.LAUNCH) only re-tiles the same pair set: density
    and force must match the default geometry to fp32 reduction-order
    tolerance (tile boundaries move, so do the per-tile partial sums)."""
    scene = _scene(dim=dim)
    solver, state_s, ids, plan, meta, pack = _seg_setup(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg
    block = scfg.block_size

    def sweeps():
        rho = ps.density_sweep_seg(pack, meta, spec, params, block,
                                   interpret=_INTERPRET)
        r, p = F.compute_pressures(rho, params)
        dv = ps.force_sweep_seg(ps.repack_eos(pack, r, p), meta, spec,
                                params, block, interpret=_INTERPRET)
        return np.asarray(rho), np.asarray(dv)

    rho1, dv1 = sweeps()
    geom = (bi, tile, 4, 1)
    monkeypatch.setitem(ps.LAUNCH, "cpu", {"scalar": geom, "vector": geom})
    assert ps.launch_config("force", True)[:2] == (bi, tile)
    rho_g, dv_g = sweeps()
    valid = np.asarray(plan.back_valid)
    np.testing.assert_allclose(rho_g[valid], rho1[valid], rtol=1e-6)
    scale = np.abs(dv1[valid]).max()
    np.testing.assert_allclose(dv_g[valid] / scale, dv1[valid] / scale,
                               atol=2e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_seg_force_matches_blocked(dim):
    """Fused force sweep vs the jnp blocked sweep on the same state;
    masked tail lanes of the last j tile of each row must stay inert
    (a non-finite lane would NaN the whole i row through coef * dx)."""
    scene = _scene(dim=dim)
    solver, state_s, ids, plan, meta, pack = _seg_setup(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg

    scfg_b = SweepConfig(impl="blocked", block_size=128, window_cap=1024)
    nd = gridops.build_neighbor_data(state_s, ids, spec, scfg_b)
    rho = F.compute_densities(state_s, nd, spec, params, scfg_b)
    rho, p = F.compute_pressures(rho, params)
    state_s = dataclasses.replace(state_s, density=rho, pressure=p)
    pack = ps.repack_eos(pack, rho, p)

    dv_b = np.asarray(F.compute_forces(state_s, nd, spec, params, scfg_b))
    dv_blk = ps.force_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=_INTERPRET,
    )
    dv_p = np.asarray(dv_blk)
    fluid = np.asarray(state_s.material) == 1
    scale = np.abs(dv_b[fluid]).max()
    np.testing.assert_allclose(
        dv_p[fluid] / scale, dv_b[fluid] / scale, atol=5e-6
    )


def test_seg_force_react_matches_separate_sweeps(tmp_path):
    """The fused force+reaction mode must equal the separate force and
    reaction sweeps EXACTLY (same per-pair arithmetic, per-i select):
    fluid rows carry dv, boundary rows the reaction force."""
    scene = _rigid_scene(tmp_path)
    solver, state_s, ids, plan, meta, pack = _seg_setup(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg

    rho = ps.density_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=_INTERPRET,
    )
    rho = jnp.where(plan.back_valid & state_s.fluid_mask, rho, state_s.density)
    rho, p = F.compute_pressures(rho, params)
    pack = ps.repack_eos(pack, rho, p)

    kw = dict(interpret=_INTERPRET)
    dv = ps.force_sweep_seg(pack, meta, spec, params, scfg.block_size, **kw)
    rx = ps.reaction_sweep_seg(pack, meta, spec, params, scfg.block_size, **kw)
    fr = ps.force_react_sweep_seg(pack, meta, spec, params, scfg.block_size, **kw)
    valid = np.asarray(plan.back_valid)
    fluid = np.asarray(state_s.material) == 1
    bound = np.asarray(state_s.material) == 0
    assert (fluid & valid).any() and (bound & valid).any()
    np.testing.assert_array_equal(np.asarray(fr)[valid & fluid],
                                  np.asarray(dv)[valid & fluid])
    np.testing.assert_array_equal(np.asarray(fr)[valid & bound],
                                  np.asarray(rx)[valid & bound])


def test_seg_bvol_active_block_skip_matches_full(tmp_path):
    """The bvol sweep with per-block boundary-occupancy skip flags must
    equal the unskipped sweep BITWISE on every consumed row (boundary &
    back_valid), and the flags must actually skip some all-fluid blocks
    on a mostly-fluid scene."""
    scene = _rigid_scene(tmp_path)
    solver, state_s, ids, plan, meta, pack = _seg_setup(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg

    kw = dict(interpret=_INTERPRET)
    full = ps.bvol_sweep_seg(pack, meta, spec, params, scfg.block_size, **kw)
    active = ps.bvol_active_blocks(pack, meta, scfg.block_size)
    act = np.asarray(active)
    assert act.any(), "no boundary-holding blocks found"
    assert (act == 0).any(), "no skippable all-fluid blocks in the scene"
    skipped = ps.bvol_sweep_seg(pack, meta, spec, params, scfg.block_size, active=active, **kw)
    valid = np.asarray(plan.back_valid)
    bound = np.asarray(state_s.material) == 0
    assert (bound & valid).any()
    np.testing.assert_array_equal(
        np.asarray(skipped)[valid & bound], np.asarray(full)[valid & bound],
        err_msg="bvol block skip changed a consumed boundary row",
    )

    # the same skip generalizes to density/force (consumed on FLUID rows)
    # and force_react (fluid|boundary rows) — bitwise on each consumer set
    fluid = np.asarray(state_s.material) == 1
    act_fl = ps.active_blocks(pack, meta, scfg.block_size, rows=(ps._FL,))
    d_full = ps.density_sweep_seg(pack, meta, spec, params, scfg.block_size, **kw)
    d_skip = ps.density_sweep_seg(pack, meta, spec, params, scfg.block_size, active=act_fl, **kw)
    np.testing.assert_array_equal(
        np.asarray(d_skip)[valid & fluid], np.asarray(d_full)[valid & fluid],
        err_msg="density block skip changed a consumed fluid row",
    )
    f_full = ps.force_sweep_seg(pack, meta, spec, params, scfg.block_size, **kw)
    f_skip = ps.force_sweep_seg(pack, meta, spec, params, scfg.block_size, active=act_fl, **kw)
    np.testing.assert_array_equal(
        np.asarray(f_skip)[valid & fluid], np.asarray(f_full)[valid & fluid],
        err_msg="force block skip changed a consumed fluid row",
    )
    act_fb = ps.active_blocks(pack, meta, scfg.block_size,
                              rows=(ps._FL, ps._BD))
    fr_full = ps.force_react_sweep_seg(pack, meta, spec, params,
                                       scfg.block_size, **kw)
    fr_skip = ps.force_react_sweep_seg(pack, meta, spec, params,
                                       scfg.block_size, active=act_fb, **kw)
    both = valid & (fluid | bound)
    np.testing.assert_array_equal(
        np.asarray(fr_skip)[both], np.asarray(fr_full)[both],
        err_msg="force_react block skip changed a consumed row",
    )


def test_seg_step_matches_blocked_trajectory():
    """Full jitted seg steps track the blocked solver to fp32
    reduction-order tolerance over a few steps."""
    scene = _scene()
    state = tt.build_state(scene)
    n = int(state.num_active)
    s_blk = tt.WCSPH(scene, sweep_cfg=SweepConfig(impl="blocked",
                                                  block_size=128, window_cap=2048))
    st_b = s_blk.bind(state)
    s_sg = tt.WCSPH(
        scene,
        sweep_cfg=SweepConfig(impl="pallas", block_size=128, window_cap=512,
                              interpret=_INTERPRET,
                              pad_capacity=8192),
    )
    st_s = s_sg.bind(state)
    for _ in range(5):
        st_b = s_blk.step(st_b)
        st_s = s_sg.step(st_s)
    xb = np.asarray(st_b.x)[:n]
    xs = np.asarray(st_s.x)[:n]
    assert np.abs(xb - xs).max() < 1e-5
    assert int(jax.device_get(st_s.occ_rowpad)) > 0


def test_seg_overflow_detected_and_regrown():
    """A too-small block capacity is detected via occ_rowpad after one
    dispatch, and run() regrows it."""
    scene = _scene()
    state = tt.build_state(scene)
    solver = tt.WCSPH(
        scene,
        sweep_cfg=SweepConfig(impl="pallas", block_size=128, window_cap=512,
                              interpret=_INTERPRET,
                              pad_capacity=8192),
    )
    state = solver.bind(state)
    # shrink the capacity AFTER bind (bind itself auto-grows a too-small one)
    solver.sweep_cfg = dataclasses.replace(solver.sweep_cfg, pad_capacity=512)
    solver._step_jit = None
    state = solver.step(state)
    need = int(jax.device_get(state.occ_rowpad))
    assert need > 512
    state = solver.run(state, 2, check_every=1)
    assert solver.sweep_cfg.pad_capacity >= need


def test_amortized_resort_divergence():
    """resort_every=2 (cached plan/meta reused every other substep) must
    track the exact per-substep resort closely: the only lost pairs are
    those whose sort-time separation exceeded one cell while their current
    distance is inside h — kernel weight O((2 d/h)^3) for CFL-bounded
    motion (WCSPH._seg_apply)."""
    scene = _scene(dim=2)
    steps = 40

    def roll(resort_every):
        state = tt.build_state(scene)
        solver = tt.WCSPH(
            scene,
            sweep_cfg=SweepConfig(impl="pallas", block_size=128,
                                  window_cap=512, interpret=_INTERPRET,
                                  pad_capacity=8192,
                                  resort_every=resort_every),
        )
        state = solver.bind(pad_state_capacity(state, 2048))
        state = dataclasses.replace(
            state, object_id=jnp.arange(state.capacity, dtype=jnp.int32)
        )
        out = jax.device_get(solver.rollout(state, steps))
        inv = np.argsort(np.asarray(out.object_id))
        return np.asarray(out.x)[inv], np.asarray(out.material)[inv]

    x1, m1 = roll(1)
    x2, m2 = roll(2)
    np.testing.assert_array_equal(m1, m2)
    act = m1 != -1
    d = np.linalg.norm(x1[act] - x2[act], axis=-1)
    h = scene.support_length
    # bounded divergence: well under one particle spacing after 40 substeps
    assert np.isfinite(x2[act]).all()
    assert d.max() < 0.25 * h, f"max divergence {d.max():.5f} vs h={h}"


def test_seg_sweeps_with_empty_stencil_rows():
    """Two fluid slabs separated by several empty grid rows: blocks near
    the gap have stencil rows with ZERO-length candidate windows, which
    the streaming compaction must skip exactly (zero 128-chunks, dest
    cursor unmoved).  Density and force vs the blocked reference."""
    scene = tt.scene_from_dict({
        "configuration": {
            "dim": 3, "domainStart": [0, 0, 0], "domainEnd": [1, 1, 1],
            "particleRadius": 0.04, "density0": 1000,
            "gravitation": [0, -9.81, 0], "c_s": 50.0,
        },
        "fluidBlocks": [
            {"start": [0.15, 0.10, 0.15], "end": [0.55, 0.22, 0.55],
             "velocity": [0.2, -1.0, 0.5], "density": 1000.0,
             "color": [50, 100, 200]},
            {"start": [0.15, 0.60, 0.15], "end": [0.55, 0.72, 0.55],
             "velocity": [-0.3, 0.4, 0.1], "density": 1000.0,
             "color": [200, 100, 50]},
        ],
        "rigidBodies": [],
    })
    solver, state_s, ids, plan, meta, pack = _seg_setup(scene)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg
    scfg_b = SweepConfig(impl="blocked", block_size=128, window_cap=2048)
    nd = gridops.build_neighbor_data(state_s, ids, spec, scfg_b)
    rho_b = np.asarray(F.compute_densities(state_s, nd, spec, params, scfg_b))
    rho_p = np.asarray(ps.density_sweep_seg(
        pack, meta, spec, params, scfg.block_size, interpret=_INTERPRET,
    ))
    fluid = np.asarray(state_s.material) == 1
    np.testing.assert_allclose(rho_p[fluid], rho_b[fluid], rtol=2e-5)

    rho, p = F.compute_pressures(jnp.asarray(rho_b), params)
    state2 = dataclasses.replace(state_s, density=rho, pressure=p)
    pack2 = ps.repack_eos(pack, rho, p)
    dv_b = np.asarray(F.compute_forces(state2, nd, spec, params, scfg_b))
    dv_p = np.asarray(ps.force_sweep_seg(
        pack2, meta, spec, params, scfg.block_size, interpret=_INTERPRET,
    ))
    assert np.isfinite(dv_p[fluid]).all()
    scale = np.abs(dv_b[fluid]).max()
    np.testing.assert_allclose(dv_p[fluid] / scale, dv_b[fluid] / scale,
                               atol=5e-6)


def test_seg_plan_sparse_runs_cut_at_x_slab_boundaries():
    """Sparse-row anchor runs must be cut at leading-axis (x-slab)
    boundaries (grid.seg_plan): a multi-x sparse block's stencil targets
    would include full dense rows of the adjacent slab (the round-2 soak's
    window blowup).  Regression for the gap-padded strides (round 3):
    rows per slab is strides[0] // res_z = res[dim-2] + 1, so a res-based
    modulus misses nearly every real boundary."""
    spec = gridops.make_grid_spec(3, [0, 0, 0], [2.0, 1.5, 1.2], 0.1)
    res = np.asarray(spec.res)
    strides = np.asarray(spec.strides)
    res_z = int(res[-1])
    assert int(strides[0]) // res_z == int(res[1]) + 1  # gap-padded

    # one particle per row across several x-slabs: ALL rows sparse
    rng = np.random.default_rng(3)
    rows = np.arange(0, (int(strides[0]) // res_z) * 4)  # 4 slabs' rows
    cx = rows // (int(strides[0]) // res_z)
    cy = rows % (int(strides[0]) // res_z)
    keep = cy < int(res[1])  # skip gap rows (no real cells there)
    ids = (cx[keep] * strides[0] + cy[keep] * strides[1]
           + rng.integers(0, res_z, keep.sum()) * strides[2]).astype(np.int32)
    ids.sort()
    n = 128 * 4
    sorted_ids = np.full((n,), spec.num_cells, np.int32)
    sorted_ids[: len(ids)] = ids
    plan = gridops.seg_plan(jnp.asarray(sorted_ids), spec, 128, 64)
    used = np.asarray(plan.seg_len) > 0
    id_first = np.asarray(plan.id_first)[used]
    id_last = np.asarray(plan.id_last)[used]
    # no block's own range may span an x-slab boundary
    np.testing.assert_array_equal(id_first // int(strides[0]),
                                  id_last // int(strides[0]))


@pytest.mark.parametrize("block_cap", [64, 6])
def test_seg_plan_back_valid_is_covered_prefix(block_cap):
    """back_valid's O(block_cap) prefix formulation must equal the
    per-particle block-membership oracle (via back_idx), including when a
    too-small block_cap CLIPS coverage mid-anchor (block_cap=6)."""
    scene = _scene(dim=3)
    state = tt.build_state(scene)
    solver = tt.WCSPH(scene, sweep_cfg=SweepConfig(
        impl="pallas", block_size=128, window_cap=512, interpret=_INTERPRET,
        pad_capacity=8192))
    state = solver.bind(pad_state_capacity(state, 2048))
    spec = solver.spec
    _, ids, _ = gridops.sort_state_by_cell(state, spec)
    plan = gridops.seg_plan(ids, spec, 128, block_cap)
    ids_np = np.asarray(ids)
    act = ids_np < spec.num_cells
    bv = np.asarray(plan.back_valid)
    # oracle: particle t is covered iff its back_idx slot's block exists,
    # agrees on position, and owns the lane
    seg_start = np.asarray(plan.seg_start)
    seg_len = np.asarray(plan.seg_len)
    own_lo = np.asarray(plan.own_lo)
    back = np.asarray(plan.back_idx)
    n = ids_np.shape[0]
    oracle = np.zeros((n,), bool)
    for t in range(n):
        if not act[t]:
            continue
        b, lane = back[t] // 128, back[t] % 128
        oracle[t] = (b < block_cap and seg_len[b] > 0
                     and seg_start[b] + lane == t
                     and own_lo[b] <= lane < own_lo[b] + seg_len[b])
    np.testing.assert_array_equal(bv, oracle)
    if block_cap == 6:
        # the clip must actually have removed coverage for this case to
        # test anything
        assert int(jax.device_get(plan.need_blocks)) > block_cap
        assert not bv[act].all()
    else:
        assert bv[act].all()


@pytest.mark.parametrize("mode", ["density", "force"])
def test_seg_separate_ipack_matches_offset_addressing(mode):
    """The 2-D sharded path's separate i-side pack must be BITWISE equal
    to the 1-D path's offset addressing of the same rows: a local plan
    over rows [off, off+n_loc) of the sorted array, sweeping with (a)
    meta.iblk + off//block against the full pack and slicing the output,
    vs (b) unshifted meta and ipack=pack[:, off:off+n_loc].  Same blocks,
    same windows, same pair arithmetic — only the i-slab addressing
    differs."""
    scene = _scene()
    solver, state_s, ids, _, _, pack = _seg_setup(scene, wcap=1024)
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg
    block, wcap = scfg.block_size, scfg.window_cap

    if mode == "force":
        scfg_b = SweepConfig(impl="blocked", block_size=128, window_cap=1024)
        nd = gridops.build_neighbor_data(state_s, ids, spec, scfg_b)
        rho = F.compute_densities(state_s, nd, spec, params, scfg_b)
        rho, p = F.compute_pressures(rho, params)
        pack = ps.repack_eos(pack, rho, p)

    off, n_loc = 256, 1024
    ids_l = ids[off:off + n_loc]
    bounds_e = gridops.csr_bounds_hist(ids, spec)
    plan = gridops.seg_plan(ids_l, spec, block, 4096 // block)
    meta, _ = ps.seg_block_meta(plan, ids, spec, block, wcap, bounds=bounds_e)
    fn = ps.density_sweep_seg if mode == "density" else ps.force_sweep_seg

    meta_off = meta._replace(iblk=meta.iblk + off // block)
    out_a = np.asarray(fn(pack, meta_off, spec, params, block,
                          interpret=_INTERPRET))[off:off + n_loc]
    out_b = np.asarray(fn(pack, meta, spec, params, block,
                          interpret=_INTERPRET,
                          ipack=pack[:, off:off + n_loc]))
    keep = np.asarray(plan.back_valid) & (np.asarray(ids_l) < spec.num_cells)
    assert keep.any()
    np.testing.assert_array_equal(out_a[keep], out_b[keep])
