"""Uniform-grid spatial binning: sort-based, atomic-free, static-shape.

This replaces the reference's two native mechanisms (SURVEY.md §2.4):

- the atomic histogram + ``PrefixSumExecutor`` + counting-sort resort
  (partice_systemv4.py:206-258) becomes a stable ``lax.sort_key_val`` on
  flat cell ids followed by a gather-permutation of all state fields — a
  single fused sort is the idiomatic XLA replacement;
- the CSR cell ranges read by ``for_all_neighbors``
  (partice_systemv4.py:331-345) become ``searchsorted`` bounds over the
  sorted ids, then per-particle *stencil runs*: with row-major flat ids
  (last axis fastest), the 3 cells {z-1, z, z+1} of each of the
  3^(dim-1) neighbor rows are contiguous in the sorted particle array, so
  the 27-cell (3D) / 9-cell (2D) neighborhood collapses to 9 / 3
  contiguous index ranges.  Sweeps then gather fixed-capacity windows of
  those runs with masks — static shapes end to end.

The reference's CSR traversal has an off-by-one making cell 0's particles
invisible (partice_systemv4.py:343, SURVEY.md §7.3); the bounds here are
exact.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from tisph.models.state import SimState, MATERIAL_INVALID


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid geometry (hashable; closed over by jit).

    cell size = support length = 4 * particle radius
    (partice_systemv4.py:34, :59-60); resolution = ceil(domain_size / cell).
    """

    dim: int
    domain_start: tuple[float, ...]
    domain_end: tuple[float, ...]
    cell_size: float
    res: tuple[int, ...]
    run_cap: int  # fixed gather capacity per stencil run (overflow-checked)

    @property
    def num_cells(self) -> int:
        """Flat id-space size (one past the max real id; also the inactive
        sentinel).  With the padded strides this exceeds prod(res) by the
        per-axis gap rows — every use in the package treats it as id-space
        size, not a physical cell count."""
        return int(self.res[0] * self.strides[0])

    @property
    def num_rows(self) -> int:
        """Stencil rows: 3^(dim-1) contiguous runs cover the 3^dim cells."""
        return 3 ** (self.dim - 1)

    @property
    def strides(self) -> tuple[int, ...]:
        """Row-major strides, last axis fastest — with each INNER non-z
        axis padded by one gap row (stride uses res+1).  The gap makes
        out-of-grid stencil offsets alias only EMPTY id space: a y
        under/overflow (cy-1 = -1 / cy+1 = ry) lands in a negative id or
        the gap row instead of wrapping into the neighboring x-column's
        real ids.  That lets the sweep kernels test membership with the
        separable per-pair form  (id_j - o_off(row)) in [lo_i, hi_i]
        without any per-(i, row) validity mask; axis 0 needs no pad (its
        overflow has no higher digit to wrap into), so 2D strides are
        unpadded.  Sort order and window contiguity are unchanged (the
        padded id is monotone in (cx, cy, z))."""
        s = [1] * self.dim
        for i in range(self.dim - 2, -1, -1):
            pad = 1 if (i + 1) <= self.dim - 2 else 0
            s[i] = s[i + 1] * (self.res[i + 1] + pad)
        return tuple(s)


def make_grid_spec(
    dim: int,
    domain_start: Sequence[float],
    domain_end: Sequence[float],
    support_length: float,
    run_cap: int = 96,
) -> GridSpec:
    res = tuple(
        int(math.ceil((e - s) / support_length))
        for s, e in zip(domain_start, domain_end)
    )
    return GridSpec(
        dim=dim,
        domain_start=tuple(float(v) for v in domain_start),
        domain_end=tuple(float(v) for v in domain_end),
        cell_size=float(support_length),
        res=res,
        run_cap=int(run_cap),
    )


def cell_coords(x: jax.Array, spec: GridSpec) -> jax.Array:
    """Integer cell coordinates, clipped into the grid.

    Reference ``pos_to_index`` (partice_systemv4.py:86-92) asserts instead of
    clipping; clipping keeps out-of-domain stragglers in edge cells so the
    step stays total (overflow is surfaced via metrics instead)."""
    start = jnp.asarray(spec.domain_start, dtype=x.dtype)
    c = jnp.floor((x - start) / spec.cell_size).astype(jnp.int32)
    hi = jnp.asarray(spec.res, dtype=jnp.int32) - 1
    return jnp.clip(c, 0, hi)


def flat_cell_ids(coords: jax.Array, material: jax.Array, spec: GridSpec) -> jax.Array:
    """Row-major flat ids (reference flatten_grid_index,
    partice_systemv4.py:100-101); inactive slots get the sentinel id
    ``num_cells`` so a stable sort pushes them to the tail."""
    strides = jnp.asarray(spec.strides, dtype=jnp.int32)
    ids = jnp.sum(coords * strides, axis=-1)
    return jnp.where(material == MATERIAL_INVALID, spec.num_cells, ids)


def sort_state_by_cell(state: SimState, spec: GridSpec) -> tuple[SimState, jax.Array, jax.Array]:
    """Spatially reorder the whole particle SoA by cell id.

    Replaces the reference's per-step counting-sort ``resort`` of 10 fields
    through double buffers (partice_systemv4.py:217-258).  Returns
    (sorted_state, sorted_ids, perm).  Stable: preserves in-cell order like
    the reference's reverse-scan counting sort.

    The permutation is applied as ONE row gather of a bit-packed (n, 15)
    f32 matrix instead of 15 per-column gathers (scattered 4-byte reads);
    non-f32 columns ride along via same-width bitcasts.
    """
    coords = cell_coords(state.x, spec)
    ids = flat_cell_ids(coords, state.material, spec)
    iota = jnp.arange(state.capacity, dtype=jnp.int32)
    sorted_ids, perm = jax.lax.sort_key_val(ids, iota, is_stable=True)

    names, widths, shapes, dtypes, cols = [], [], [], [], []
    for f in dataclasses.fields(state):
        a = getattr(state, f.name)
        if getattr(a, "ndim", 0) < 1:
            continue
        m = a.reshape(a.shape[0], -1)
        if m.dtype != jnp.float32:
            assert m.dtype.itemsize == 4, f.name
            m = jax.lax.bitcast_convert_type(m, jnp.float32)
        names.append(f.name)
        widths.append(m.shape[1])
        shapes.append(a.shape)
        dtypes.append(a.dtype)
        cols.append(m)
    packed = jnp.concatenate(cols, axis=1)
    packed = jnp.take(packed, perm, axis=0)
    out = {}
    o = 0
    for name, w, shape, dtype in zip(names, widths, shapes, dtypes):
        m = packed[:, o:o + w]
        o += w
        if dtype != jnp.float32:
            m = jax.lax.bitcast_convert_type(m, dtype)
        out[name] = m.reshape(shape)
    return dataclasses.replace(state, **out), sorted_ids, perm


def csr_bounds(sorted_ids: jax.Array, spec: GridSpec) -> jax.Array:
    """bounds[c] = first sorted index with cell id >= c, for c in [0, G].

    The particles of cell c occupy sorted[bounds[c]:bounds[c+1]] — the CSR
    structure the reference builds with an atomic histogram + parallel
    prefix sum (partice_systemv4.py:206-215, :255)."""
    queries = jnp.arange(spec.num_cells + 1, dtype=sorted_ids.dtype)
    return jnp.searchsorted(sorted_ids, queries, side="left").astype(jnp.int32)


def csr_bounds_scan(ids: jax.Array, spec: GridSpec) -> jax.Array:
    """CSR bounds via histogram + parallel prefix sum — the literal XLA
    translation of the reference's atomic histogram +
    ``ti.algorithms.PrefixSumExecutor`` (partice_systemv4.py:206-215, :255):
    the atomic scatter becomes ``segment_sum`` and the native scan becomes
    ``jnp.cumsum`` (log-depth on device).

    Equivalent to :func:`csr_bounds` (which binary-searches the sorted ids
    instead — fewer passes when ids are already sorted; this variant does
    NOT require sorted input).  Kept as the reference-shaped alternative
    and used by tests as a cross-check.
    """
    counts = jax.ops.segment_sum(
        jnp.ones_like(ids, dtype=jnp.int32),
        ids,
        num_segments=spec.num_cells + 1,  # +1 = the inactive sentinel bin
    )
    ends = jnp.cumsum(counts[: spec.num_cells])
    return jnp.concatenate([jnp.zeros((1,), ends.dtype), ends]).astype(jnp.int32)


def csr_bounds_hist(ids: jax.Array, spec: GridSpec) -> jax.Array:
    """CSR bounds via a scatter-add histogram + prefix sum — does NOT
    require sorted input.  Built once per seg rebuild and shared by
    seg_plan + seg_block_meta, turning all their window searches into pure
    gathers (on the GPU the scatter-add is several times faster than
    :func:`csr_bounds`' binary search, see PERF.md).

    bounds[c] = #(ids < c), c in [0, num_cells] — on sorted ids the first
    index with id >= c (same contract as :func:`csr_bounds`).  Bin 0
    counts negative ids (the -1 head of the sharded paths' neutralised
    halo chunks), the last bin the inactive sentinels."""
    counts = jnp.zeros((spec.num_cells + 2,), jnp.int32).at[
        jnp.clip(ids, -1, spec.num_cells) + 1
    ].add(1)
    return jnp.cumsum(counts[: spec.num_cells + 1]).astype(jnp.int32)


def _segment_of(starts: jax.Array, size: int) -> jax.Array:
    """For each position in [0, size): the index of the segment it falls in,
    where segment s covers [starts[s], starts[s+1]).  ``starts`` must be
    non-decreasing with starts[0] == 0.  Scatter + cumsum — O(size) with a
    small scatter instead of a searchsorted per position."""
    marks = jnp.zeros((size + 1,), jnp.int32).at[
        jnp.minimum(starts[1:], size)
    ].add(1, mode="drop")
    return jnp.cumsum(marks[:size])


class SegPlan(NamedTuple):
    """Anchor-segmented logical blocks over the compact cell-sorted array
    (see :func:`seg_plan`).  All arrays static-shape; ``block_cap`` logical
    blocks of ``block`` i-lanes each."""

    seg_start: jax.Array   # (block_cap,) i32 — compact, block-aligned block start
    seg_len: jax.Array     # (block_cap,) i32 — own lanes (0 = unused block)
    own_lo: jax.Array      # (block_cap,) i32 — first own lane within the
    #                        block (own range = [own_lo, own_lo + seg_len))
    id_first: jax.Array    # (block_cap,) i32 — cell id of first own particle
    id_last: jax.Array     # (block_cap,) i32 — cell id of last own particle
    back_idx: jax.Array    # (n,) i32 — block-output slot of each compact
    #                        index.  DIAGNOSTIC ONLY since the compact
    #                        own-mask kernel output (round 3): no solver
    #                        consumes it, so XLA dead-code-eliminates it
    #                        inside the jitted step; the plan-consistency
    #                        test and tools/microbench_meta.py still read
    #                        it eagerly as the block-partition oracle.
    back_valid: jax.Array  # (n,) bool — compact index is covered by a block
    need_blocks: jax.Array  # () i32 — blocks this step actually needs;
    #                         > block_cap means trailing regions lost coverage


def seg_plan(
    sorted_ids: jax.Array,
    spec: GridSpec,
    block: int,
    block_cap: int,
    bounds: jax.Array | None = None,
    dense_min: int = 32,
) -> SegPlan:
    """Partition the compact cell-sorted array into *anchor*-confined
    logical blocks:

    - every DENSE grid row (>= ``dense_min`` particles; a row = the
      contiguous z-run of cells sharing leading coords) is its own anchor —
      blocks confined to one row keep candidate windows at the
      [z_first-1, z_last+1] single-column density floor, immune to the
      linear layout's cross-row straddle blowup;
    - maximal runs of consecutive SPARSE rows share one anchor — their
      particles are contiguous in sorted order, so spray that wets
      thousands of near-empty rows costs ceil(particles/block) blocks, not
      one block per wetted row (the round-2 soak measured the per-row rule
      exploding 3.6k -> 15k blocks as a dam-break wet every (x,y) column).

    Anchor blocks start at the block-aligned floor of the anchor's first
    particle; leading/overhang lanes compute against the wrong windows and
    are discarded by the back map.  A block's candidate window per stencil
    offset is the contiguous id range [id_first - z..., id_last + z...]
    derived from its own first/last particle ids (seg_block_meta); since a
    multi-row block's windows of adjacent stencil offsets can overlap, the
    sweep kernel applies a per-pair cell-id membership test (sort-time ids
    on both sides — also what keeps the cached structure consistent under
    resort_every amortization).

    ``need_blocks > block_cap`` (detected after every dispatch via
    SolverBase.run, same contract as window overflow) means trailing
    regions lost sweep coverage this step; the inactive sentinel tail is
    never covered (``back_valid`` false — callers keep prior values there).
    """
    n = sorted_ids.shape[0]
    res_z = int(spec.res[-1])
    num_rows = spec.num_cells // res_z

    align = block  # block starts index the packed array in block units
    if bounds is None:
        bounds = csr_bounds_hist(sorted_ids, spec)
    row_queries = jnp.arange(num_rows + 1, dtype=jnp.int32) * res_z
    in_starts = bounds[jnp.minimum(row_queries, spec.num_cells)].astype(jnp.int32)
    counts = jnp.diff(in_starts)

    # anchors: dense rows, and the first row of every maximal sparse run
    # (a sparse run is also cut after a dense row so runs stay contiguous)
    dense = counts >= dense_min
    prev_dense = jnp.concatenate([jnp.asarray([True]), dense[:-1]])
    is_anchor = dense | prev_dense  # sparse row after dense/array start
    r_idx = jnp.arange(num_rows, dtype=jnp.int32)
    if spec.dim >= 3:
        # cut sparse runs at leading-axis (x) boundaries: spray above a dam
        # pile connects across ALL x-slabs through the sparse top rows, and
        # a multi-x sparse block's stencil targets would include full DENSE
        # pile rows of the adjacent slab — measured in the round-2 soak as
        # window caps spiraling 1314 -> 9344.  Within one slab, sparsity is
        # height-correlated, so same-height targets stay sparse.  Rows per
        # x-slab come from the STRIDES, not res: the gap-padded id space
        # (GridSpec.strides) gives each slab res[dim-2] + 1 rows, so a
        # res-based modulus would cut at arbitrary mid-slab rows and miss
        # nearly every real boundary.
        rows_per_slab = int(np.asarray(spec.strides)[0]) // res_z
        is_anchor = is_anchor | ((r_idx % rows_per_slab) == 0)
    # anchor row of each row: itself if anchor else the nearest anchor above
    anchor_of = jax.lax.associative_scan(
        jnp.maximum, jnp.where(is_anchor, r_idx, -1)
    )
    # per-ANCHOR extent: start = in_starts[a]; end = in_starts of the NEXT
    # anchor.  The next-anchor row comes from a reverse min-scan (in_starts
    # is monotone, so "max in_starts[r+1] over the anchor's rows" IS
    # in_starts[next anchor]) — a scan + gather replaces the two
    # segment_max scatters of an earlier version (the scan is
    # log-depth).
    a_start = in_starts[:-1]  # (R,) start of each row
    nxt = jax.lax.associative_scan(
        jnp.minimum,
        jnp.where(is_anchor, r_idx, num_rows),
        reverse=True,
    )
    nxt = jnp.concatenate([nxt[1:], jnp.asarray([num_rows], jnp.int32)])
    anchor_end = in_starts[nxt]  # valid at anchor rows
    s0 = (a_start // align) * align  # (R,) aligned anchor origin (valid at anchors)
    span = jnp.maximum(anchor_end - s0, 0)
    # anchor holds >= 1 particle iff its [start, end) range is non-empty
    nblk = jnp.where(
        is_anchor & (anchor_end > a_start), (span + block - 1) // block, 0
    )
    blk_cum = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(nblk, dtype=jnp.int32)]
    )
    need_blocks = blk_cum[-1]
    blk_cum = jnp.minimum(blk_cum, block_cap)

    row_of = _segment_of(blk_cum, block_cap)  # block -> anchor row in [0, R]
    b = jnp.arange(block_cap, dtype=jnp.int32)
    r = jnp.minimum(row_of, num_rows - 1)
    k_in_row = b - blk_cum[r]
    # clip stays on the alignment grid: block starts index the packed array
    # in units of ``block`` (SegMeta.iblk)
    seg_start = jnp.clip(
        s0[r] + k_in_row * block, 0, max(((n - 1) // align) * align, 0)
    )
    own_lo = jnp.clip(a_start[r] - seg_start, 0, block)
    own_hi = jnp.clip(anchor_end[r] - seg_start, 0, block)
    seg_len = jnp.where(row_of < num_rows, jnp.maximum(own_hi - own_lo, 0), 0)

    id_first = sorted_ids[jnp.clip(seg_start + own_lo, 0, n - 1)].astype(jnp.int32)
    id_last = sorted_ids[jnp.clip(seg_start + own_hi - 1, 0, n - 1)].astype(jnp.int32)
    id_first = jnp.minimum(id_first, spec.num_cells - 1)
    id_last = jnp.minimum(id_last, spec.num_cells - 1)

    # validity: block coverage is always a PREFIX of the compact active
    # array — anchors partition it contiguously, each anchor's blocks
    # cover its whole [a_start, anchor_end) range, and a block_cap clip
    # removes a SUFFIX of blocks (a partially covered boundary anchor
    # keeps its leading particles, later anchors get nothing).  So
    # per-particle validity needs NO (n,)-sized gather at all: one
    # O(block_cap) reduction gives the covered prefix end.
    covered_end = jnp.max(jnp.where(seg_len > 0, seg_start + own_hi, 0))
    t = jnp.arange(n, dtype=jnp.int32)
    back_valid = (t < covered_end) & (sorted_ids < spec.num_cells)

    # inverse map (DIAGNOSTIC ONLY — see SegPlan.back_idx; dead under jit
    # so the (n, 3) row gather below costs nothing in production):
    # compact index -> block-output slot via the particle's anchor row
    # (= anchor_of[ids[t] // res_z]; sentinel tail -> invalid).  The three
    # per-anchor quantities are packed into ONE per-ROW table so the
    # eager path costs a single 3-column row gather instead of four
    # scalar gathers.
    rtab = jnp.stack(
        [s0[anchor_of], blk_cum[anchor_of], blk_cum[anchor_of + 1]], axis=1
    )  # (R, 3) — gathers over num_rows only
    rtab = jnp.concatenate([rtab, jnp.asarray([[0, 0, 0]], jnp.int32)])
    row_of_t = jnp.minimum(sorted_ids // res_z, num_rows).astype(jnp.int32)
    tt = rtab[row_of_t]  # (n, 3) row gather
    off_t = t - tt[:, 0]
    bb = tt[:, 1] + off_t // block
    back_idx = jnp.clip(bb * block + off_t % block, 0, block_cap * block - 1)
    return SegPlan(
        seg_start, seg_len, own_lo, id_first, id_last,
        back_idx, back_valid, need_blocks,
    )


def suggest_block_capacity(
    state: SimState, spec: GridSpec, block: int = 128, slack: float = 2.0
) -> int:
    """Static seg-layout block capacity (in particle SLOTS, block_cap*block):
    base blocks for the full capacity plus headroom for anchor
    fragmentation (each anchor — a dense row or a sparse-row run — wastes
    at most ~2 blocks of alignment overlap, and the number of anchors is
    bounded by particles/dense_min, not by wetted rows — the anchor plan
    exists precisely so spray over thousands of rows stays cheap).
    Adaptive regrow (SolverBase.run) corrects underestimates at runtime."""
    base = -(-state.capacity // block)
    headroom = max(int(base * (slack - 1.0)), 1024)
    return (base + headroom) * block


def _row_offsets(spec: GridSpec) -> np.ndarray:
    """Static (num_rows, dim-1) array of stencil row offsets in {-1,0,1}."""
    if spec.dim == 1:
        return np.zeros((1, 0), dtype=np.int32)
    grids = np.meshgrid(*([np.arange(-1, 2, dtype=np.int32)] * (spec.dim - 1)), indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=-1)


def stencil_runs(coords: jax.Array, bounds: jax.Array, spec: GridSpec) -> jax.Array:
    """Per-particle neighbor runs: (N, num_rows, 2) int32 [start, end).

    For a particle in cell (c_0..c_{d-1}) and row offset (o_0..o_{d-2}), the
    run covers cells (c+o, z) for z in [c_{d-1}-1, c_{d-1}+1] clipped — one
    contiguous slice of the sorted particle array.  Rows falling outside the
    grid yield *clamped-empty* runs [s, s): positioned at the nearest valid
    cell so that, within each stencil row, run starts and ends stay
    monotonically non-decreasing over the sorted particle order.  That
    monotonicity is what lets the blocked sweep cover a whole particle
    block's candidates with ONE contiguous window per row
    (see ops/neighbors.py).
    """
    offsets = _row_offsets(spec)  # (R, dim-1) static
    res = np.asarray(spec.res)
    strides = np.asarray(spec.strides)

    lead = coords[:, : spec.dim - 1]  # (N, dim-1)
    z = coords[:, spec.dim - 1]  # (N,)
    z_lo = jnp.maximum(z - 1, 0)
    z_hi = jnp.minimum(z + 1, int(res[-1]) - 1)

    runs = []
    for o in offsets:
        nb = lead + jnp.asarray(o, dtype=jnp.int32)  # (N, dim-1)
        valid = jnp.all((nb >= 0) & (nb < jnp.asarray(res[:-1], dtype=jnp.int32)), axis=-1)
        nb_cl = jnp.clip(nb, 0, jnp.asarray(res[:-1] - 1, dtype=jnp.int32))
        base = jnp.sum(nb_cl * jnp.asarray(strides[:-1], dtype=jnp.int32), axis=-1)
        c_lo = base + z_lo
        c_hi = base + z_hi
        start = bounds[jnp.clip(c_lo, 0, spec.num_cells)]
        end = jnp.where(valid, bounds[jnp.clip(c_hi + 1, 0, spec.num_cells)], start)
        runs.append(jnp.stack([start, end], axis=-1))
    return jnp.stack(runs, axis=1)  # (N, num_rows, 2)


def cell_target_ranges(coords: jax.Array, spec: GridSpec) -> jax.Array:
    """Per-particle stencil-row cell-id ranges: (N, num_rows, 2) int32
    [c_lo, c_hi] (inclusive).

    For row offset o, a window particle j is a stencil candidate of i iff
    its flat cell id lies in [flat(lead_i+o, z_i-1), flat(lead_i+o, z_i+1)]
    (clipped).  This turns the neighbor-membership test into pure arithmetic
    on cell ids — no CSR bounds array, no per-particle gathers (the
    reference's for_all_neighbors needs the prefix-sum array for this,
    partice_systemv4.py:331-345).  Rows outside the grid get the empty
    range [0, -1].
    """
    offsets = _row_offsets(spec)
    res = np.asarray(spec.res)
    strides = np.asarray(spec.strides)

    lead = coords[:, : spec.dim - 1]
    z = coords[:, spec.dim - 1]
    z_lo = jnp.maximum(z - 1, 0)
    z_hi = jnp.minimum(z + 1, int(res[-1]) - 1)

    ranges = []
    for o in offsets:
        nb = lead + jnp.asarray(o, dtype=jnp.int32)
        valid = jnp.all((nb >= 0) & (nb < jnp.asarray(res[:-1], dtype=jnp.int32)), axis=-1)
        base = jnp.sum(nb * jnp.asarray(strides[:-1], dtype=jnp.int32), axis=-1)
        c_lo = jnp.where(valid, base + z_lo, 0)
        c_hi = jnp.where(valid, base + z_hi, -1)
        ranges.append(jnp.stack([c_lo, c_hi], axis=-1))
    return jnp.stack(ranges, axis=1)


def block_window_bounds(
    sorted_ids: jax.Array,
    coords: jax.Array,
    spec: GridSpec,
    block_size: int,
    ids_i: jax.Array | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Per-(block, row) candidate-window [start, end) bounds, each
    (num_blocks, rows) int32, in j-array (sorted) coordinates.

    The window for a block/row begins at the first sorted particle whose
    cell id >= the MINIMUM of the row's per-particle c_lo over the block,
    and ends past the last particle with id <= the MAXIMUM c_hi.
    (Reductions, not first/last sampling: per-row c_lo is monotone over
    sorted order EXCEPT at clamped grid edges, where two different leads
    can clip onto the same edge cell with decreasing z — sampling the first
    particle there overshoots and silently drops edge-cell neighbors.)
    Costs two searchsorteds of num_blocks*rows queries — thousands, not the
    num_cells (~10^5-10^6) a full CSR bounds array would need.
    """
    n = coords.shape[0]
    num_blocks = -(-n // block_size)
    padded = num_blocks * block_size
    offsets = _row_offsets(spec)
    res = np.asarray(spec.res)
    strides = np.asarray(spec.strides)

    lead = coords[:, : spec.dim - 1]
    z = coords[:, spec.dim - 1]
    z_lo = jnp.maximum(z - 1, 0)
    z_hi = jnp.minimum(z + 1, int(res[-1]) - 1)
    lo_qs, hi_qs = [], []
    for o in offsets:
        # Particles whose row offset leaves the grid have NO candidates in
        # this row: exclude them from the reductions (lo query = num_cells,
        # hi query = -1) instead of clamping onto an edge column — clamping
        # dragged edge-block windows across whole x-slabs of irrelevant
        # particles.
        nb = lead + jnp.asarray(o, dtype=jnp.int32)
        valid = jnp.all(
            (nb >= 0) & (nb < jnp.asarray(res[:-1], dtype=jnp.int32)), axis=-1
        )
        base = jnp.sum(nb * jnp.asarray(strides[:-1], dtype=jnp.int32), axis=-1)
        lo_qs.append(jnp.where(valid, base + z_lo, spec.num_cells))
        hi_qs.append(jnp.where(valid, base + z_hi, -1))
    q_lo = jnp.stack(lo_qs, axis=1)  # (n, rows)
    q_hi = jnp.stack(hi_qs, axis=1)
    # Inactive (sentinel-id) rows derive coords from their parked positions,
    # not their sort position — excluding them keeps a mixed tail block's
    # window anchored on its ACTIVE particles (else the min drags the
    # window far below them and the capped length truncates coverage).
    # ``ids_i`` are the ids aligned with ``coords`` (the i side); in the
    # sharded setting ``sorted_ids`` is the halo-extended j array and MUST
    # NOT be used for this mask.
    if ids_i is None:
        ids_i = sorted_ids[:n]
    inactive = (ids_i >= spec.num_cells)[:, None]
    q_lo = jnp.where(inactive, spec.num_cells, q_lo)
    q_hi = jnp.where(inactive, -1, q_hi)
    if padded != n:
        q_lo = jnp.pad(q_lo, ((0, padded - n), (0, 0)), constant_values=spec.num_cells)
        q_hi = jnp.pad(q_hi, ((0, padded - n), (0, 0)), constant_values=-1)
    lo_min = jnp.min(q_lo.reshape(num_blocks, block_size, -1), axis=1)
    hi_max = jnp.max(q_hi.reshape(num_blocks, block_size, -1), axis=1)
    starts = jnp.searchsorted(sorted_ids, lo_min.reshape(-1), side="left")
    ends = jnp.searchsorted(sorted_ids, hi_max.reshape(-1) + 1, side="left")
    shape = (num_blocks, spec.num_rows)
    return (
        starts.reshape(shape).astype(jnp.int32),
        ends.reshape(shape).astype(jnp.int32),
    )


def block_window_starts(
    sorted_ids: jax.Array,
    coords: jax.Array,
    spec: GridSpec,
    block_size: int,
    ids_i: jax.Array | None = None,
) -> jax.Array:
    """Per-(block, row) window start indices (see block_window_bounds)."""
    return block_window_bounds(sorted_ids, coords, spec, block_size, ids_i)[0]


def max_window_length(runs: jax.Array, block_size: int) -> jax.Array:
    """Longest per-block candidate window: for blocks of ``block_size``
    consecutive sorted particles, window = last particle's run end - first
    particle's run start, maximised over blocks and stencil rows.  This is
    the quantity the blocked sweep's ``window_cap`` must bound."""
    n = runs.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    if pad:
        runs = jnp.concatenate([runs, jnp.zeros((pad,) + runs.shape[1:], runs.dtype)])
    blocks = runs.reshape(nb, block_size, runs.shape[1], 2)
    # min/max over the block, ignoring empty runs (clamped-out rows, pad)
    pad_mask = (jnp.arange(nb * block_size).reshape(nb, block_size) >= n)[..., None]
    empty = (blocks[..., 0] >= blocks[..., 1]) | pad_mask
    starts = jnp.where(empty, np.iinfo(np.int32).max, blocks[..., 0])
    ends = jnp.where(empty, 0, blocks[..., 1])
    start_min = jnp.min(starts, axis=1)
    win = jnp.maximum(jnp.max(ends, axis=1) - start_min, 0)
    return jnp.max(win)


def _host_runs(state: SimState, spec: GridSpec) -> np.ndarray:
    """Numpy replica of sort -> bounds -> stencil runs for one-time,
    host-side capacity measurement (avoids a device compile at bind time)."""
    x = np.asarray(jax.device_get(state.x), dtype=np.float64)
    mat = np.asarray(jax.device_get(state.material))
    start = np.asarray(spec.domain_start)
    res = np.asarray(spec.res)
    strides = np.asarray(spec.strides)
    coords = np.clip(
        np.floor((x - start) / spec.cell_size).astype(np.int64), 0, res - 1
    )
    ids = (coords * strides).sum(axis=-1)
    ids[mat == MATERIAL_INVALID] = spec.num_cells
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    coords = coords[order]
    inactive = sorted_ids >= spec.num_cells
    bounds = np.searchsorted(sorted_ids, np.arange(spec.num_cells + 1), side="left")

    offsets = _row_offsets(spec)
    lead = coords[:, : spec.dim - 1]
    z = coords[:, spec.dim - 1]
    z_lo = np.maximum(z - 1, 0)
    z_hi = np.minimum(z + 1, int(res[-1]) - 1)
    runs = np.zeros((x.shape[0], len(offsets), 2), dtype=np.int64)
    for r, o in enumerate(offsets):
        nb = lead + o
        valid = ((nb >= 0) & (nb < res[:-1])).all(axis=-1)
        nb_cl = np.clip(nb, 0, res[:-1] - 1)
        base = (nb_cl * strides[:-1]).sum(axis=-1)
        s = bounds[np.clip(base + z_lo, 0, spec.num_cells)]
        e = np.where(valid, bounds[np.clip(base + z_hi + 1, 0, spec.num_cells)], s)
        # inactive rows get inert tail runs so capacity measurements ignore
        # their parked-position coords
        s = np.where(inactive, x.shape[0], s)
        e = np.where(inactive, x.shape[0], e)
        runs[:, r, 0] = s
        runs[:, r, 1] = e
    return runs


def suggest_window_cap(
    state: SimState,
    spec: GridSpec,
    block_size: int,
    slack: float = 1.5,
    runs: np.ndarray | None = None,
) -> int:
    """Measure the max block window of the initial configuration and pad
    with slack, rounded to a multiple of 128 (lane width).  Host-side."""
    if runs is None:
        runs = _host_runs(state, spec)
    n = runs.shape[0]
    nb = -(-n // block_size)
    pad = nb * block_size - n
    if pad:
        tail = np.zeros((pad,) + runs.shape[1:], runs.dtype)
        tail[..., 0] = n
        runs = np.concatenate([runs, tail])
    blocks = runs.reshape(nb, block_size, runs.shape[1], 2)
    # ignore empty runs (clamped-out rows, inactive, pad) in the reductions
    empty = blocks[..., 0] >= blocks[..., 1]
    starts = np.where(empty, np.iinfo(np.int64).max, blocks[..., 0])
    ends = np.where(empty, 0, blocks[..., 1])
    m = int(np.maximum(ends.max(axis=1) - starts.min(axis=1), 0).max())
    return max(128, int(-(-(m * slack) // 128) * 128))


def build_neighbor_data(sorted_state, sorted_ids: jax.Array, spec: GridSpec, cfg):
    """Build the per-step neighbor structure for the configured sweep impl.

    Called once per solver step right after the resort (the reference's
    ``ps.update()`` analog) and shared by every sweep in the step.
    """
    from tisph.ops.neighbors import NeighborData  # avoid cycle

    coords = cell_coords(sorted_state.x, spec)
    if cfg.impl == "gather":
        bounds = csr_bounds(sorted_ids, spec)
        runs = stencil_runs(coords, bounds, spec)
        # per-dispatch overflow diagnostic: longest ACTIVE run vs spec.run_cap
        # (inactive tail rows carry parked-position coords — mask them out)
        active = (sorted_ids < spec.num_cells)[:, None]
        lens = jnp.where(active, runs[..., 1] - runs[..., 0], 0)
        return NeighborData(runs=runs, window_need=jnp.max(lens))
    if cfg.impl in ("blocked", "pallas"):  # pallas generic path = blocked
        wstarts, wends = block_window_bounds(
            sorted_ids, coords, spec, cfg.block_size
        )
        return NeighborData(
            cell_ranges=cell_target_ranges(coords, spec),
            wstarts=wstarts,
            sorted_ids=sorted_ids,
            # longest window any block actually needs this step; compared
            # against cfg.window_cap by SolverBase.run after every dispatch
            window_need=jnp.max(jnp.maximum(wends - wstarts, 0)),
        )
    raise ValueError(f"unknown sweep impl {cfg.impl!r}")


def max_run_length(runs: jax.Array) -> jax.Array:
    """Longest run across all particles/rows — overflow accounting against
    ``spec.run_cap`` (the reference instead corrupts memory on cell overflow,
    partice_systemv3.py:214-217; we surface it as a metric)."""
    return jnp.max(runs[..., 1] - runs[..., 0])


def suggest_halo_rows(
    state: SimState, spec: GridSpec, shard_rows: int, slack: float = 2.0
) -> int:
    """Measure how many sorted rows a shard's stencil candidates reach into
    its neighbors (host-side, at bind).

    With equal-row sharding of the sorted array, shard d owns rows
    [d*P, (d+1)*P); its particles' candidate segments [start, end) can
    extend up to one x/y cell row away in flat-id order — a data-dependent
    number of ROWS.  The halo must cover
    max(own_start - min(run starts), max(run ends) - own_end) over shards.
    """
    runs = _host_runs(state, spec)
    n = runs.shape[0]
    worst = 0
    for s0 in range(0, n, shard_rows):
        s1 = min(s0 + shard_rows, n)
        starts = runs[s0:s1, :, 0]
        ends = runs[s0:s1, :, 1]
        worst = max(worst, int(s0 - starts.min()), int(ends.max() - s1))
    return max(128, int(-(-(worst * slack) // 128) * 128))


def measure_caps_device(
    state: SimState, spec: GridSpec, block_size: int, shard_rows: int | None = None
) -> tuple[int, int, int]:
    """One jitted device pass measuring (max_run_len, max_block_window,
    max_halo_reach) of the current configuration; only scalars cross the
    device->host boundary."""

    @functools.partial(jax.jit, static_argnums=(1, 2))
    def _measure(st: SimState, block: int, srows: int | None):
        st_s, ids, _ = sort_state_by_cell(st, spec)
        bounds = csr_bounds(ids, spec)
        coords = cell_coords(st_s.x, spec)
        runs = stencil_runs(coords, bounds, spec)
        inact = (ids >= spec.num_cells)[:, None, None]
        runs = jnp.where(inact, jnp.asarray(st.capacity, runs.dtype), runs)
        run_len = jnp.max(runs[..., 1] - runs[..., 0])
        window = max_window_length(runs, block)
        if srows:
            n = runs.shape[0]
            nb = n // srows
            starts = jnp.where(
                runs[..., 0] >= runs[..., 1], np.iinfo(np.int32).max, runs[..., 0]
            ).reshape(nb, srows, -1)
            ends = jnp.where(
                runs[..., 0] >= runs[..., 1], 0, runs[..., 1]
            ).reshape(nb, srows, -1)
            own_start = jnp.arange(nb) * srows
            own_end = own_start + srows
            left = jnp.max(own_start[:, None] - jnp.min(starts, axis=1).min(axis=-1)[:, None])
            right = jnp.max(jnp.max(ends, axis=1).max(axis=-1)[:, None] - own_end[:, None])
            halo = jnp.maximum(jnp.maximum(left, right), 0)
        else:
            halo = jnp.asarray(0)
        return run_len, window, halo

    r, w, h = jax.device_get(_measure(state, block_size, shard_rows))
    return int(r), int(w), int(h)


def suggest_run_cap(
    state: SimState, spec: GridSpec, slack: float = 1.5, runs: np.ndarray | None = None
) -> int:
    """Measure the max run length of the initial configuration and pad with
    slack, rounded to a multiple of 8.  Host-side, at build time."""
    if runs is None:
        runs = _host_runs(state, spec)
    m = int((runs[..., 1] - runs[..., 0]).max())
    return max(8, int(-(-(m * slack) // 8) * 8))
