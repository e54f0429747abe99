"""Property tests: the sort/CSR/stencil-run neighbor structure must find
exactly the same neighbor sets as a brute-force O(n^2) oracle (SURVEY.md §4b)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tisph.models.state import SimState, MATERIAL_FLUID, make_state
from tisph.ops import grid as gridops
from tisph.ops.neighbors import neighbor_sweep


def _random_state(n, dim, seed, lo, hi, volume0=1.0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, size=(n, dim)).astype(np.float32)
    return make_state(
        positions=x,
        velocities=np.zeros((n, dim), np.float32),
        densities=np.full(n, 1000.0, np.float32),
        pressures=np.zeros(n, np.float32),
        materials=np.full(n, MATERIAL_FLUID, np.int32),
        colors=np.zeros((n, 3), np.float32),
        object_ids=np.zeros(n, np.int32),
        volume0=volume0,
        capacity=n + 8,  # padding slots exercise the sentinel-cell path
    )


@pytest.mark.parametrize("dim,n", [(2, 200), (3, 300), (2, 37), (3, 64)])
def test_neighbor_sets_match_bruteforce(dim, n):
    h = 0.1
    spec = gridops.make_grid_spec(dim, [0.0] * dim, [1.0] * dim, h, run_cap=max(64, n))
    state = _random_state(n, dim, seed=dim * 100 + n, lo=0.0, hi=1.0)

    sorted_state, sorted_ids, _ = gridops.sort_state_by_cell(state, spec)
    bounds = gridops.csr_bounds(sorted_ids, spec)
    coords = gridops.cell_coords(sorted_state.x, spec)
    runs = gridops.stencil_runs(coords, bounds, spec)

    # Accumulate per-particle neighbor count and index-sum through the sweep.
    tags = jnp.arange(state.capacity, dtype=jnp.int32).astype(jnp.float32)

    def pair(i, j, r_vec, r2, w, grad_w):
        return {"count": jnp.ones_like(r2), "tag_sum": j["tag"]}

    acc = neighbor_sweep(
        runs, sorted_state.x, {}, {"tag": tags}, pair,
        {"count": jnp.zeros(state.capacity), "tag_sum": jnp.zeros(state.capacity)},
        spec, h,
        chunk_size=64,  # exercise the chunked path (N not divisible by 64)
    )
    count = np.asarray(acc["count"])
    tag_sum = np.asarray(acc["tag_sum"])

    # Brute force on the sorted positions.
    xs = np.asarray(sorted_state.x, dtype=np.float64)
    active = np.asarray(sorted_state.material) == MATERIAL_FLUID
    d = np.linalg.norm(xs[:, None, :] - xs[None, :, :], axis=-1)
    brute = (d < h) & ~np.eye(state.capacity, dtype=bool)
    brute &= active[None, :] & active[:, None]

    np.testing.assert_array_equal(count[active], brute.sum(axis=1)[active])
    expected_tag = (brute * np.arange(state.capacity)[None, :]).sum(axis=1)
    np.testing.assert_allclose(tag_sum[active], expected_tag[active], rtol=1e-6)


def test_run_overflow_detection():
    """Clustered points must trip the max_run_length accounting."""
    dim = 2
    h = 0.1
    spec = gridops.make_grid_spec(dim, [0.0, 0.0], [1.0, 1.0], h, run_cap=8)
    state = _random_state(100, dim, seed=7, lo=0.45, hi=0.55)  # all in ~1 cell
    sorted_state, sorted_ids, _ = gridops.sort_state_by_cell(state, spec)
    bounds = gridops.csr_bounds(sorted_ids, spec)
    coords = gridops.cell_coords(sorted_state.x, spec)
    runs = gridops.stencil_runs(coords, bounds, spec)
    assert int(gridops.max_run_length(runs)) > spec.run_cap


def test_sort_is_stable_and_complete():
    dim = 3
    spec = gridops.make_grid_spec(dim, [0.0] * 3, [1.0] * 3, 0.25, run_cap=8)
    state = _random_state(50, dim, seed=3, lo=0.0, hi=1.0)
    sorted_state, sorted_ids, perm = gridops.sort_state_by_cell(state, spec)
    # permutation property
    assert sorted(np.asarray(perm).tolist()) == list(range(state.capacity))
    # ids ascend
    ids = np.asarray(sorted_ids)
    assert (np.diff(ids) >= 0).all()
    # inactive padding at the tail, binned to the sentinel cell
    mat = np.asarray(sorted_state.material)
    n_inactive = (mat == -1).sum()
    assert n_inactive == state.capacity - 50
    assert (ids[-n_inactive:] == spec.num_cells).all()
    # stable: equal ids preserve original relative order
    orig_ids = np.asarray(
        gridops.flat_cell_ids(gridops.cell_coords(state.x, spec), state.material, spec)
    )
    p = np.asarray(perm)
    for c in np.unique(ids):
        members = p[ids == c]
        assert (np.diff(members) > 0).all(), f"cell {c} not stable"
    assert (np.sort(orig_ids) == ids).all()


def test_blocked_sweep_edge_cells_complete():
    """Regression: per-row window starts are NOT monotone at clamped grid
    edges (two leads can clip onto the same edge cell with decreasing z);
    first-particle sampling dropped edge-cell neighbors.  Verify neighbor
    counts against brute force for a cloud hugging the domain corner."""
    dim = 3
    h = 0.16
    spec = gridops.make_grid_spec(dim, [0.0] * 3, [1.0] * 3, h, run_cap=512)
    # dense cloud in the low corner -> many particles in edge cells
    state = _random_state(600, dim, seed=11, lo=0.0, hi=0.4)
    sorted_state, sorted_ids, _ = gridops.sort_state_by_cell(state, spec)
    coords = gridops.cell_coords(sorted_state.x, spec)
    nd_ranges = gridops.cell_target_ranges(coords, spec)
    wstarts = gridops.block_window_starts(sorted_ids, coords, spec, 64)

    from tisph.ops.neighbors import neighbor_sweep_blocked

    def pair(i, j, r_vec, r2, w, grad_w):
        return {"count": jnp.ones_like(r2)}

    acc = neighbor_sweep_blocked(
        nd_ranges, wstarts, sorted_ids, sorted_state.x, {}, {}, pair,
        {"count": jnp.zeros(state.capacity)}, spec, h,
        block_size=64, window_cap=608,
    )
    count = np.asarray(acc["count"])

    xs = np.asarray(sorted_state.x, dtype=np.float32)
    active = np.asarray(sorted_state.material) == MATERIAL_FLUID
    d2 = ((xs[:, None, :] - xs[None, :, :]) ** 2).sum(-1)
    brute = (d2 < np.float32(h) * np.float32(h)) & ~np.eye(state.capacity, dtype=bool)
    brute &= active[None, :] & active[:, None]
    np.testing.assert_array_equal(count[active], brute.sum(axis=1)[active])


def test_csr_bounds_scan_matches_searchsorted():
    """The histogram+prefix-sum CSR (the reference's PrefixSumExecutor
    shape) must equal the searchsorted CSR on sorted ids."""
    dim = 3
    spec = gridops.make_grid_spec(dim, [0.0] * 3, [1.0] * 3, 0.2, run_cap=64)
    state = _random_state(300, dim, seed=5, lo=0.0, hi=1.0)
    _, sorted_ids, _ = gridops.sort_state_by_cell(state, spec)
    a = np.asarray(gridops.csr_bounds(sorted_ids, spec))
    b = np.asarray(gridops.csr_bounds_scan(sorted_ids, spec))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dim,n", [(2, 300), (3, 700)])
def test_csr_bounds_hist_matches_searchsorted(dim, n):
    """The two CSR builds — the scatter-histogram + prefix sum the seg
    rebuild uses and the binary search over the sorted ids — must agree,
    including the inactive sentinel tail, a neutralised -1 head (the
    sharded halo's edge chunks) and empty leading cells."""
    spec = gridops.make_grid_spec(dim, [0.0] * dim, [1.0] * dim, 0.07,
                                  run_cap=64)
    state = _random_state(n, dim, seed=7, lo=0.0, hi=1.0)
    _, sorted_ids, _ = gridops.sort_state_by_cell(state, spec)
    # park a tail at the inactive sentinel like the solver does, and a
    # head at -1 like a neutralised halo chunk
    sorted_ids = sorted_ids.at[-n // 7:].set(spec.num_cells)
    sorted_ids = sorted_ids.at[: n // 11].set(-1)
    a = np.asarray(gridops.csr_bounds_hist(sorted_ids, spec))
    b = np.asarray(gridops.csr_bounds(sorted_ids, spec))
    np.testing.assert_array_equal(a, b)


def test_csr_bounds_cover_cell0():
    """Regression guard for the reference's off-by-one that makes cell 0
    invisible (partice_systemv4.py:343)."""
    dim = 2
    spec = gridops.make_grid_spec(dim, [0.0, 0.0], [1.0, 1.0], 0.5, run_cap=8)
    # Two particles in cell (0,0), close together.
    state = _random_state(2, dim, seed=0, lo=0.01, hi=0.05)
    sorted_state, sorted_ids, _ = gridops.sort_state_by_cell(state, spec)
    bounds = gridops.csr_bounds(sorted_ids, spec)
    coords = gridops.cell_coords(sorted_state.x, spec)
    runs = gridops.stencil_runs(coords, bounds, spec)

    def pair(i, j, r_vec, r2, w, grad_w):
        return {"count": jnp.ones_like(r2)}

    acc = neighbor_sweep(
        runs, sorted_state.x, {}, {}, pair,
        {"count": jnp.zeros(state.capacity)}, spec, 0.5,
    )
    assert np.asarray(acc["count"])[:2].tolist() == [1.0, 1.0]
