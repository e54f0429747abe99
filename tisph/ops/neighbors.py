"""Vectorised neighbor iteration over stencil runs.

Vectorised equivalent of the reference's ``for_all_neighbors`` task-callback
traversal (partice_systemv4.py:331-345): instead of a per-particle dynamic
loop over 3^dim cells, a ``lax.scan`` over the 3^(dim-1) stencil rows
gathers fixed-capacity masked windows of the cell-sorted particle array and
evaluates the pair callback on whole blocks of lanes at once.  The callback
(``pair_fn``) plays the role of the reference's ``@ti.func`` tasks
(e.g. compute_density_task, wcsphv2.py:18-25) but is vectorised and fused by
XLA into the surrounding sweep.

Memory scaling: the i-particle axis is processed in chunks (an outer
``lax.scan``), so peak transient memory is O(chunk * run_cap) regardless of
particle count — the same blockwise window structure the Pallas kernels
use, run here as a sequential scan over blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, NamedTuple

import jax
import jax.numpy as jnp

from tisph.ops.grid import GridSpec
from tisph.ops.kernels import cubic_kernel, cubic_kernel_grad


class NeighborData(NamedTuple):
    """Pytree of per-step neighbor-structure arrays (built once per step,
    shared by all sweeps).  Use :func:`tisph.ops.grid.build_neighbor_data`."""

    runs: object = None         # (N, rows, 2) — gather impl
    cell_ranges: object = None  # (N, rows, 2) — blocked impl
    wstarts: object = None      # (blocks, rows) — blocked impl
    sorted_ids: object = None   # (N,) — blocked impl
    window_need: object = None  # () i32 — longest window/run this structure
    #                             needs (overflow check vs the static cap)


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Static selection of the neighbor-sweep implementation.

    - ``gather``: per-particle masked window gathers (reference tier).
    - ``blocked``: contiguous per-block windows via dynamic_slice — the
      plain XLA path (see :func:`neighbor_sweep_blocked`); the CPU default.
    - ``pallas``: the Triton-route seg-layout kernels
      (ops/pallas/sweeps.py); the GPU default, and in interpret mode the
      kernels' CPU test path.
    """

    impl: str = "blocked"
    chunk_size: int | None = None  # gather impl: i-axis chunk
    block_size: int = 128          # blocked/pallas impl: particles per block
    window_cap: int = 1024         # blocked/pallas impl: candidate window length
    interpret: bool = False        # pallas impl: interpreter mode (CPU tests)
    pad_capacity: int = 0          # pallas impl: logical-block capacity in
    #                                particle slots (block_cap * block_size,
    #                                grid.seg_plan)
    resort_every: int = 1          # pallas rollouts: rebuild sort/plan/meta
    #                                every N substeps and reuse the cached
    #                                structure in between (Verlet-skin-style
    #                                amortization; pairs are r2-tested with
    #                                CURRENT positions, so staleness only
    #                                loses pairs whose kernel weight is
    #                                O((2 d_moved / h)^3) — see
    #                                WCSPH._seg_apply).  1 = exact resort
    #                                every substep (the reference's cadence,
    #                                sph_basev2.py:211).


def platform_sweep_impl(platform: str) -> str:
    """The sweep implementation auto-selected for a JAX platform: the
    compiled Pallas kernels on a GPU, the plain XLA blocked sweep on the
    CPU.  Any other platform has no tuned path and is an error."""
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "blocked"
    raise ValueError(f"no neighbor-sweep path for platform {platform!r}")


def sweep(
    nd: NeighborData,
    x_sorted,
    i_fields,
    j_fields,
    pair_fn,
    init_acc,
    spec: GridSpec,
    support_length: float,
    cfg: SweepConfig,
    x_i: jax.Array | None = None,
    i_offset: int = 0,
):
    """Dispatch to the configured sweep implementation.

    impl='pallas' falls back to 'blocked' here: the Pallas kernels implement
    the WCSPH sweeps specifically, while this generic task-callback path
    serves everything else (legacy solver, boundary volumes, tests).
    """
    if cfg.impl == "gather":
        if x_i is not None:
            raise NotImplementedError("halo-extended i side requires impl='blocked'")
        return neighbor_sweep(
            nd.runs, x_sorted, i_fields, j_fields, pair_fn, init_acc,
            spec, support_length, cfg.chunk_size,
        )
    if cfg.impl in ("blocked", "pallas"):
        return neighbor_sweep_blocked(
            nd.cell_ranges, nd.wstarts, nd.sorted_ids, x_sorted,
            i_fields, j_fields, pair_fn, init_acc,
            spec, support_length, cfg.block_size, cfg.window_cap,
            x_i=x_i, i_offset=i_offset,
        )
    raise ValueError(f"unknown sweep impl {cfg.impl!r}")

# pair_fn(i_fields, j_fields, r_vec, r2, w, grad_w) -> pytree of per-pair
# contributions with leading shape (chunk, run_cap).  i_fields leaves are
# pre-expanded to (chunk, 1[, dim]) so they broadcast against j lanes.
PairFn = Callable[..., object]


def _expand_i(leaf: jax.Array) -> jax.Array:
    """(C, ...) -> (C, 1, ...) so i-side fields broadcast over j lanes."""
    return leaf[:, None] if leaf.ndim == 1 else leaf[:, None, :]


def neighbor_sweep(
    runs: jax.Array,
    x_sorted: jax.Array,
    i_fields: Mapping[str, jax.Array],
    j_fields: Mapping[str, jax.Array],
    pair_fn: PairFn,
    init_acc,
    spec: GridSpec,
    support_length: float,
    chunk_size: int | None = None,
):
    """Accumulate pair contributions over all neighbors.

    Args:
      runs: (N, num_rows, 2) int32 stencil runs from :func:`stencil_runs`.
      x_sorted: (N, dim) positions in cell-sorted order (gather source).
      i_fields: name -> (N, ...) arrays read on the i side (sliced per chunk
        and pre-expanded for broadcasting).
      j_fields: name -> (N, ...) arrays gathered on the j side.
      pair_fn: per-pair physics; invalid lanes are masked centrally (the
        callback need not handle padding or self-pairs, mirroring the
        reference criterion ``p_i != p_j and |r| < h``,
        partice_systemv4.py:344).
      init_acc: pytree of (N, ...) accumulator start values (e.g. W(0)
        self-terms or gravity).
      chunk_size: i-axis block size; None processes all particles at once.

    Returns the accumulated pytree with leading shape (N, ...).
    """
    n = x_sorted.shape[0]
    cap = spec.run_cap
    h = support_length
    lane = jnp.arange(cap, dtype=jnp.int32)

    if chunk_size is None or chunk_size >= n:
        chunk_size = n
    num_chunks = -(-n // chunk_size)
    padded = num_chunks * chunk_size

    def pad_i(a: jax.Array) -> jax.Array:
        if padded == n:
            return a
        pad_widths = [(0, padded - n)] + [(0, 0)] * (a.ndim - 1)
        return jnp.pad(a, pad_widths)  # padded rows get empty runs => no work

    runs_p = pad_i(runs)
    x_i_p = pad_i(x_sorted)
    i_fields_p = {k: pad_i(v) for k, v in i_fields.items()}
    init_p = jax.tree.map(pad_i, init_acc)

    def chunk_body(_, c):
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, c * chunk_size, chunk_size, axis=0)
        runs_c = jnp.moveaxis(sl(runs_p), 1, 0)  # (num_rows, C, 2)
        x_i = sl(x_i_p)  # (C, dim)
        own = c * chunk_size + jnp.arange(chunk_size, dtype=jnp.int32)
        ifc = {k: _expand_i(sl(v)) for k, v in i_fields_p.items()}
        acc0 = jax.tree.map(sl, init_p)

        def row_body(acc, run_row):
            starts = run_row[:, 0]
            ends = run_row[:, 1]
            idx = starts[:, None] + lane[None, :]  # (C, cap)
            valid = (idx < ends[:, None]) & (idx != own[:, None])
            safe = jnp.where(valid, idx, 0)

            x_j = jnp.take(x_sorted, safe, axis=0)  # (C, cap, dim)
            r_vec = x_i[:, None, :] - x_j
            r2 = jnp.sum(r_vec * r_vec, axis=-1)
            valid = valid & (r2 < h * h)

            jfc = {k: jnp.take(a, safe, axis=0) for k, a in j_fields.items()}
            w = cubic_kernel(jnp.sqrt(r2), h, spec.dim)
            grad_w = cubic_kernel_grad(r_vec, h, spec.dim)

            contrib = pair_fn(ifc, jfc, r_vec, r2, w, grad_w)

            def reduce_leaf(acc_leaf, c_leaf):
                mask = valid.reshape(valid.shape + (1,) * (c_leaf.ndim - 2))
                return acc_leaf + jnp.sum(jnp.where(mask, c_leaf, 0.0), axis=1)

            return jax.tree.map(reduce_leaf, acc, contrib), None

        acc, _ = jax.lax.scan(row_body, acc0, runs_c)
        return None, acc

    if num_chunks == 1:
        _, acc = chunk_body(None, jnp.asarray(0, jnp.int32))
        return acc
    _, accs = jax.lax.scan(chunk_body, None, jnp.arange(num_chunks, dtype=jnp.int32))
    # accs leaves: (num_chunks, C, ...) -> (padded, ...) -> trim to (N, ...)
    return jax.tree.map(
        lambda a: a.reshape((padded,) + a.shape[2:])[:n], accs
    )


def neighbor_sweep_blocked(
    cell_ranges: jax.Array,
    wstarts: jax.Array,
    sorted_ids: jax.Array,
    x_sorted: jax.Array,
    i_fields: Mapping[str, jax.Array],
    j_fields: Mapping[str, jax.Array],
    pair_fn: PairFn,
    init_acc,
    spec: GridSpec,
    support_length: float,
    block_size: int = 128,
    window_cap: int = 1024,
    x_i: jax.Array | None = None,
    i_offset: int = 0,
):
    """Gather-free blocked sweep — the plain XLA path.

    This variant exploits the cell-sorted layout and uses NO gathers at
    all:

    - particles are processed in blocks of ``block_size`` consecutive sorted
      indices (a block spans a handful of adjacent cells);
    - within one stencil row, per-particle candidate segments are monotone
      in sorted order, so the union of a block's candidates is ONE
      contiguous window of the sorted array, starting at the per-(block,
      row) index in ``wstarts`` (tisph.ops.grid.block_window_starts);
    - the window (``window_cap`` long) is fetched with ``lax.dynamic_slice``
      — a DMA, not a gather — and each particle masks its own candidates by
      comparing the window's *cell ids* against its arithmetic target range
      ``cell_ranges[i, row] = [c_lo, c_hi]`` — no CSR bounds array exists
      anywhere;
    - the block then computes dense (block, window) masked pair
      interactions: pure elementwise work.

    This is the flash-attention-style blockwise streaming structure of
    SURVEY.md §5.7(a), with XLA managing block residency; the Pallas
    kernels run the same structure one program per block, in parallel.

    Window overflow (true candidate span longer than ``window_cap``) is
    detectable post-hoc via :func:`tisph.ops.grid.max_window_length`;
    overflowing lanes are dropped (never out-of-bounds reads).

    Args:
      cell_ranges: (N_i, num_rows, 2) inclusive [c_lo, c_hi] per-particle
        stencil cell-id ranges (grid.cell_target_ranges).
      wstarts: (num_blocks, num_rows) window start indices
        (grid.block_window_starts), in j-array coordinates.
      sorted_ids: (N_j,) flat cell ids of the j (candidate) array.
      x_i / i_offset: in the sharded (halo-extended) setting the i side is a
        sub-range of the j array: ``x_i`` holds the N_i i-positions and
        ``i_offset`` is their start index within the j array (for
        self-pair exclusion).  Defaults: i side == j side.
    """
    n_j = x_sorted.shape[0]
    if x_i is None:
        x_i_arr = x_sorted
    else:
        x_i_arr = x_i
    n = x_i_arr.shape[0]
    h = support_length
    window_cap = min(window_cap, n_j)  # window cannot exceed the j array
    block_size = min(block_size, n)
    lane = jnp.arange(window_cap, dtype=jnp.int32)
    num_blocks = -(-n // block_size)
    padded = num_blocks * block_size

    def pad_i(a: jax.Array) -> jax.Array:
        if padded == n:
            return a
        return jnp.pad(a, [(0, padded - n)] + [(0, 0)] * (a.ndim - 1))

    if padded == n:
        ranges_p = cell_ranges
    else:
        # padded rows get the empty range [1, 0] so they select no lanes
        tail = jnp.zeros((padded - n, cell_ranges.shape[1], 2), cell_ranges.dtype)
        tail = tail.at[..., 0].set(1)
        ranges_p = jnp.concatenate([cell_ranges, tail], axis=0)
    x_i_p = pad_i(x_i_arr)
    i_fields_p = {k: pad_i(v) for k, v in i_fields.items()}
    init_p = jax.tree.map(pad_i, init_acc)

    def block_body(_, k):
        i0 = k * block_size
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, i0, block_size, axis=0)
        ranges_b = jnp.moveaxis(sl(ranges_p), 1, 0)  # (rows, B, 2)
        wstarts_b = jax.lax.dynamic_slice(wstarts, (k, 0), (1, wstarts.shape[1]))[0]
        x_i_blk = sl(x_i_p)[:, None, :]  # (B, 1, dim)
        own = i_offset + i0 + jnp.arange(block_size, dtype=jnp.int32)
        ifc = {k2: _expand_i(sl(v)) for k2, v in i_fields_p.items()}
        acc0 = jax.tree.map(sl, init_p)

        def row_body(acc, row_in):
            rng, wstart0 = row_in
            c_lo = rng[:, 0]  # (B,)
            c_hi = rng[:, 1]
            wstart = jnp.clip(wstart0, 0, n_j - window_cap)
            g = wstart + lane  # (W,) j-array indices of the window

            wsl = lambda a: jax.lax.dynamic_slice_in_dim(a, wstart, window_cap, axis=0)
            ids_w = wsl(sorted_ids)  # (W,)
            x_j = wsl(x_sorted)[None, :, :]  # (1, W, dim)
            r_vec = x_i_blk - x_j  # (B, W, dim)
            r2 = jnp.sum(r_vec * r_vec, axis=-1)  # (B, W)
            valid = (
                (ids_w[None, :] >= c_lo[:, None])
                & (ids_w[None, :] <= c_hi[:, None])
                & (g[None, :] != own[:, None])
                & (r2 < h * h)
            )

            jfc = {}
            for k2, a in j_fields.items():
                s = wsl(a)
                jfc[k2] = s[None, :] if s.ndim == 1 else s[None, :, :]
            w = cubic_kernel(jnp.sqrt(r2), h, spec.dim)
            grad_w = cubic_kernel_grad(r_vec, h, spec.dim)

            contrib = pair_fn(ifc, jfc, r_vec, r2, w, grad_w)

            def reduce_leaf(acc_leaf, c_leaf):
                mask = valid.reshape(valid.shape + (1,) * (c_leaf.ndim - 2))
                return acc_leaf + jnp.sum(jnp.where(mask, c_leaf, 0.0), axis=1)

            return jax.tree.map(reduce_leaf, acc, contrib), None

        acc, _ = jax.lax.scan(row_body, acc0, (ranges_b, wstarts_b))
        return None, acc

    _, accs = jax.lax.scan(block_body, None, jnp.arange(num_blocks, dtype=jnp.int32))
    return jax.tree.map(lambda a: a.reshape((padded,) + a.shape[2:])[:n], accs)
