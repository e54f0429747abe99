"""The compiled Triton kernels on the card.  Marked ``gpu``: they skip
elsewhere (a compiled kernel has no CPU path; its arithmetic is covered
by the interpret-mode suites) and run on the card through chip_smoke.py."""

import numpy as np
import pytest

import tisph as tt
from tisph.models.state import pad_state_capacity
from tisph.ops import forces as F
from tisph.ops import grid as gridops
from tisph.ops.neighbors import SweepConfig
from tisph.ops.pallas import sweeps as ps

from test_pallas import check_step_against_oracle
from test_seg import _rigid_scene

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("mode", ["density", "force", "bvol", "reaction",
                                  "force_react"])
def test_compiled_sweep_matches_interpret(mode, gpu, tmp_path):
    """Each kernel mode compiled for the card against the same kernel in
    interpret mode (XLA on the same card) on one sorted state: only the
    compilers' evaluation order differs."""
    scene = _rigid_scene(tmp_path)
    solver = tt.WCSPH(scene, sweep_cfg=SweepConfig(
        impl="pallas", block_size=128, window_cap=512))
    state = solver.bind(pad_state_capacity(tt.build_state(scene), 4096))
    spec, params, scfg = solver.spec, solver.params, solver.sweep_cfg
    st, ids, _ = gridops.sort_state_by_cell(state, spec)
    plan = gridops.seg_plan(ids, spec, scfg.block_size,
                            scfg.pad_capacity // scfg.block_size)
    meta, _ = ps.seg_block_meta(plan, ids, spec, scfg.block_size,
                                scfg.window_cap)
    pack = ps.pack_state(st.x, st.v, st.density, st.pressure, st.mass,
                         st.volume, st.material, ids, params)
    rho, p = F.compute_pressures(
        ps.density_sweep_seg(pack, meta, spec, params, scfg.block_size),
        params)
    pack = ps.repack_eos(pack, rho, p)

    out = [np.asarray(ps._run_sweep_seg(pack, meta, mode, spec, params,
                                        scfg.block_size, interp))
           for interp in (False, True)]
    rows = (np.asarray(plan.back_valid)
            & (np.asarray(st.material) == (1 if mode in ("density", "force")
                                           else 0)))
    if mode == "force_react":
        rows = np.asarray(plan.back_valid) & (np.asarray(st.material) >= 0)
    assert rows.any()
    a, b = out[0][:, rows], out[1][:, rows]
    scale = np.abs(b).max()
    assert np.isfinite(a).all() and scale > 0
    np.testing.assert_allclose(a / scale, b / scale, atol=1e-5)


@pytest.mark.parametrize("dim", [2, 3])
def test_compiled_step_matches_oracle(dim, gpu):
    check_step_against_oracle(dim, interpret=False)
