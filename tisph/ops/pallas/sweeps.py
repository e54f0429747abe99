"""Fused Pallas neighbor sweeps for WCSPH, compiled for the GPU through
Triton (``pallas_call(..., backend="triton")``).

Same blockwise-window structure as ops/neighbors.neighbor_sweep_blocked —
cell-sorted particles, one contiguous candidate window per (block, stencil
row) — over the seg layout's row-confined logical blocks (grid.seg_plan):

- the j-side state is packed into ONE transposed (16, N) f32 array (fields
  on the leading axis, particles contiguous), so each field of a j tile is
  one coalesced load; cell ids ride along as exact f32 integers, guarded by
  ``num_cells < 2**24``;
- one program per (logical block, slice of its i lanes).  The program
  holds its i lanes in registers and, for each stencil row, walks the
  row's window ``[start, start + len)`` in power-of-two j tiles with
  masked loads straight from device memory (the pack is L2-resident at
  the flagship size);
- nothing carries between programs: each writes only the lanes its block
  owns, through a masked store, so programs may run in any order;
- all pair math is (lanes, tile) 2-D component arithmetic with per-tile
  row reductions — no matrix product (a Gram-form r2 cancels at
  r2 ~ h^2 << |x|^2, see ROADMAP "No Gram-form distances");
- per-pair physics is identical to the factories in ops/forces.py
  (reference equations wcsphv2.py:18-93, sph_basev2.py:64-78).

Packed-row layout (transposed):
  0..2  x | 3 cell id (f32) | 4 eff_mass (fluid*m + bound*rho0*V — the
  density-sweep coefficient) | 5 bound | 6 density | 7 p/rho^2
  (precomputed per particle, saves a per-lane divide in the force sweep)
  8..10 v | 11 mass | 12 volume | 13 fluid | 14 pressure | 15 fl*mass
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from tisph.config import SolverParams
from tisph.models.state import MATERIAL_BOUNDARY, MATERIAL_FLUID
from tisph.ops.grid import GridSpec, _row_offsets
from tisph.ops.kernels import cubic_kernel_sigma

F_ROWS = 16
_X, _ID, _EFFM, _BD, _RHO, _PRHO2 = 0, 3, 4, 5, 6, 7
_V, _M, _VOL, _FL, _P = 8, 11, 12, 13, 14
_FLM = 15  # fl * m (precomputed: the force tile's fluid-mass coefficient;
#            bd * rho0 * V falls out as _EFFM - _FLM)

_SCALAR_MODES = ("density", "bvol")
_MODES = _SCALAR_MODES + ("force", "reaction", "force_react")

# Launch geometry per device kind and mode family: (i lanes per program,
# j-tile width, warps, pipeline stages).  Powers of two (Triton).  Tuned
# on the card with tools/tune_seg_launch.py at the 195k flagship (PERF.md:
# 8 warps over a small (32, 32) tile won for both families; stages made
# no difference); "cpu" is the interpreter's (CPU tests).
LAUNCH = {
    "NVIDIA H100 80GB HBM3": {
        "scalar": (32, 32, 8, 3),
        "vector": (32, 32, 8, 3),
    },
    "cpu": {
        "scalar": (128, 128, 4, 1),
        "vector": (128, 128, 4, 1),
    },
}


def _device_kind() -> str:
    """``device_kind`` of the card the compiled kernels run on."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise ValueError(
            f"compiled seg sweeps need a GPU, not {dev.platform!r}; on the "
            "CPU pass interpret=True"
        )
    return dev.device_kind


def launch_config(mode: str, interpret: bool) -> tuple[int, int, int, int]:
    """(bi, tile, num_warps, num_stages) for ``mode`` on this device."""
    kind = "cpu" if interpret else _device_kind()
    if kind not in LAUNCH:
        raise ValueError(
            f"no seg-sweep launch geometry for device kind {kind!r}; add "
            "one to tisph.ops.pallas.sweeps.LAUNCH"
        )
    return LAUNCH[kind]["scalar" if mode in _SCALAR_MODES else "vector"]


def pack_state(
    x: jax.Array,
    v: jax.Array,
    density: jax.Array,
    pressure: jax.Array,
    mass: jax.Array,
    volume: jax.Array,
    material: jax.Array,
    sorted_ids: jax.Array,
    params: SolverParams,
) -> jax.Array:
    """Pack sorted per-particle fields into the transposed (16, N) array."""
    n, dim = x.shape
    fl = (material == MATERIAL_FLUID).astype(jnp.float32)
    bd = (material == MATERIAL_BOUNDARY).astype(jnp.float32)
    zero = jnp.zeros((n,), jnp.float32)
    rows = [zero] * F_ROWS
    for a in range(dim):
        rows[_X + a] = x[:, a]
        rows[_V + a] = v[:, a]
    rows[_RHO] = density
    rows[_P] = pressure
    rows[_M] = mass
    rows[_VOL] = volume
    rows[_FL] = fl
    rows[_BD] = bd
    rows[_FLM] = fl * mass
    rows[_EFFM] = rows[_FLM] + bd * (params.density0 * volume)
    rows[_ID] = sorted_ids.astype(jnp.float32)
    rows[_PRHO2] = pressure / jnp.maximum(density * density, 1e-12)
    return jnp.stack(rows, axis=0)


def repack_eos(pack: jax.Array, density: jax.Array, pressure: jax.Array) -> jax.Array:
    """Update the density/pressure-derived rows between the two sweeps."""
    return (
        pack.at[_RHO, :].set(density)
        .at[_P, :].set(pressure)
        .at[_PRHO2, :].set(pressure / jnp.maximum(density * density, 1e-12))
    )


def _pair_terms(mode, dim, h, params, ivals, xi, jrow, valid):
    """Per-pair contributions on one (lanes, tile) tile: a tuple of masked
    (B, T) arrays, one per output component, which the caller sums over
    the tile.  ``jrow(r)`` loads pack row ``r`` of the j tile as (T,).

    Every mode's contribution is uniformly proportional to the spline
    normalisation k_sig (and the gradient modes' to grad W's 1/h): both
    are applied once per i at output time (_fin_scale)."""
    dx = [xi[a][:, None] - jrow(_X + a)[None, :] for a in range(dim)]
    r2 = dx[0] * dx[0]
    for a in range(1, dim):
        r2 = r2 + dx[a] * dx[a]
    # one rsqrt replaces sqrt + divide: r_norm = r2 * rs, 1/r = rs
    rs = jax.lax.rsqrt(jnp.maximum(r2, 1e-12))
    q = (r2 * rs) * (1.0 / h)
    # branchless cubic spline: W/k = 2(1-q)+^3 - 8(0.5-q)+^3 and
    # dW/dq /k = -6(1-q)+^2 + 24(0.5-q)+^2 reproduce the piecewise form
    # with two clamps instead of four selects, and the q > 1 cutoff comes
    # free from the clamps
    p1 = jnp.maximum(1.0 - q, 0.0)
    p2 = jnp.maximum(0.5 - q, 0.0)
    p1sq = p1 * p1
    p2sq = p2 * p2
    w = 2.0 * p1 * p1sq - 8.0 * p2 * p2sq

    if mode in _SCALAR_MODES:
        # density: eff_mass_j W; bvol: the Akinci boundary-volume
        # denominator delta_i = W(0) + sum_{j bnd} W (sph_basev2.py:195-201)
        coef = jrow(_EFFM if mode == "density" else _BD)[None, :]
        return (jnp.where(valid, coef * w, 0.0),)

    # grad W = gmag * r_vec.  No small-r guard: mag -> 0 linearly as
    # q -> 0, so mag * rs stays bounded, and the self pair needs no
    # exclusion — every term is multiplied by dx, bitwise 0 for i == j
    gmag = (24.0 * p2sq - 6.0 * p1sq) * rs
    vi = ivals["vi"]
    dot = (vi[0][:, None] - jrow(_V)[None, :]) * dx[0]
    for a in range(1, dim):
        dot = dot + (vi[a][:, None] - jrow(_V + a)[None, :]) * dx[a]
    # both divides feed only the (heuristic) viscosity terms
    dot_neg = jnp.minimum(dot, 0.0) / (r2 + 0.01 * h * h)
    flm = jrow(_FLM)[None, :]
    rho_j = jrow(_RHO)[None, :]
    p_rho2_j = jrow(_PRHO2)[None, :]
    nu_b_coef = params.boundary_sigma * h * params.c_s * 0.5

    if mode == "reaction":
        # fluid -> boundary reaction (forces.rigid_reaction_kernel):
        # F_i = bvol_i * sum_{j fluid} m_j (nu_b(rho_j) dot_neg - p/rho^2_j)
        #       gradW . r_vec    with bvol_i = rho0 V_i
        nu_b = nu_b_coef / jnp.maximum(rho_j, 1e-12)
        coef = flm * (nu_b * dot_neg - p_rho2_j)
        coef = jnp.where(valid, ivals["bvol_i"] * coef * gmag, 0.0)
        return tuple(coef * dx[a] for a in range(dim))

    effm = jrow(_EFFM)[None, :]
    bdv = effm - flm  # bd * rho0 * V_j
    nu_f = (2.0 * params.viscosity * h * params.c_s) / (ivals["rho_i"] + rho_j)
    # algebraic regroup of flm*(nu_f*dot_neg - (pi+pj)) + bdv*(nu_b_i*
    # dot_neg - pi): the pressure part collapses through flm + bdv = effm
    # to effm*pi + flm*pj
    visc = dot_neg * (flm * nu_f + bdv * ivals["nu_b_i"])
    press = effm * ivals["p_rho2_i"] + flm * p_rho2_j
    grad_coef = visc - press
    if mode == "force_react":
        # fused force + fluid->boundary reaction (rigid two-way coupling):
        # fluid i accumulates its dv, boundary i the reaction force of
        # forces.rigid_reaction_kernel in ONE pass over the shared windows
        # (per-pair arithmetic of each side is identical to the separate
        # sweeps; coh_i is pre-masked to fluid i in _ivals, so the
        # boundary rows' cohesion term is an exact +0)
        nu_b_j = nu_b_coef / jnp.maximum(rho_j, 1e-12)
        react = ivals["bvol_i"] * (flm * (nu_b_j * dot_neg - p_rho2_j))
        grad_coef = jnp.where(ivals["fl_i"] > 0.0, grad_coef, react)
    coef = jnp.where(valid, grad_coef * gmag + (ivals["coh_i"] * flm) * w, 0.0)
    return tuple(coef * dx[a] for a in range(dim))


def _fin_scale(mode, k_sig, h):
    """Uniform per-pair scale applied once per i: the spline normalisation
    for every mode, times grad W's 1/h for the gradient modes (whose
    cohesion term compensates via coh_i)."""
    return k_sig if mode in _SCALAR_MODES else k_sig / h


def _ivals(mode, dim, params, irow):
    """Per-i operands, computed once per program: the force modes' per-i
    viscosity/cohesion coefficients, and ``bias``, the per-axis constant
    (gravity) added after the reduction.  Returns (ivals, bias)."""
    h = params.support_length
    if mode in _SCALAR_MODES:
        # self term rides IN the sweep: j = i passes the id test, W(0) =
        # k_sig, and effm_i = m_i for the fluid i the density output is
        # kept for (bd_i = 1 for the boundary i bvol keeps)
        return {}, None
    out = {"vi": [irow(_V + a) for a in range(dim)]}
    if mode in ("reaction", "force_react"):
        out["bvol_i"] = (params.density0 * irow(_VOL))[:, None]
    if mode == "reaction":
        return out, None
    rho_i = irow(_RHO)
    # the finalizer scales gradient-mode sums by k_sig/h; the cohesion
    # term has no 1/h, so an h is folded into its per-i coefficient
    coh_i = -(h * params.surface_tension * (1.0 / jnp.maximum(irow(_M), 1e-30)))
    fl_i = irow(_FL)
    if mode == "force_react":
        # boundary i rows accumulate the reaction force instead of a fluid
        # dv: mask the fluid-only cohesion and gravity terms per i
        coh_i = jnp.where(fl_i > 0.0, coh_i, 0.0)
        out["fl_i"] = fl_i[:, None]
    out["rho_i"] = rho_i[:, None]
    out["p_rho2_i"] = irow(_PRHO2)[:, None]
    out["coh_i"] = coh_i[:, None]
    out["nu_b_i"] = (params.boundary_sigma * h * params.c_s / (2.0 * rho_i))[:, None]
    grav = [float(params.gravity[a]) for a in range(dim)]
    if mode == "force_react":
        return out, tuple(g * fl_i for g in grav)
    return out, tuple(grav)


def _n_out(mode: str, dim: int) -> int:
    return 1 if mode in _SCALAR_MODES else dim


# ---------------------------------------------------------------------------
# Seg layout: row-confined logical blocks (grid.seg_plan)
# ---------------------------------------------------------------------------


class SegMeta(NamedTuple):
    """Seg sweep metadata (see :func:`seg_block_meta`).  Every leaf has
    the logical-block axis first, so the sharded solvers shard it like
    the particle arrays."""

    wstart: jax.Array  # (block_cap, rows) i32 — candidate window start per
    #                    (block, stencil row), in j-array coordinates
    wlen: jax.Array    # (block_cap, rows) i32 — window length, clipped to
    #                    the window cap
    iblk: jax.Array    # (block_cap,) i32 — i-slab index, units of block
    own: jax.Array     # (block_cap, 2) i32 — the block's own lane range
    #                    [own_lo, own_hi): the only lanes it writes


def seg_block_meta(
    plan, sorted_ids: jax.Array, spec: GridSpec, block: int, window: int,
    bounds: jax.Array | None = None,
) -> tuple["SegMeta", jax.Array]:
    """(SegMeta, need) for the seg layout.

    Per logical block b (grid.seg_plan) and stencil row, the candidate
    window of one neighbor column is the sorted range [start, end) of the
    cells the block's own id span can reach through that row, clipped to
    ``window`` lanes.

    ``need`` = longest window any block requires; compared against
    ``window`` by SolverBase.run after every dispatch (``need > window``
    means the far end of some column was clipped this step).

    ``sorted_ids`` is the array the windows index (the sharded paths pass
    their halo-extended ids, with ``bounds`` built over them).
    """
    strides = np.asarray(spec.strides)
    offs = [
        int(np.dot(o, strides[: spec.dim - 1])) if spec.dim > 1 else 0
        for o in _row_offsets(spec)
    ]
    if bounds is None:
        from tisph.ops.grid import csr_bounds_hist

        bounds = csr_bounds_hist(sorted_ids, spec)

    # Candidate window per stencil offset O = o . strides[:-1]: an id span
    # [lo, hi] has offset-O targets in [lo + O - 1, hi + O + 1] (z +/- 1 in
    # flat id space), clipped into the grid.  Out-of-grid targets clip to
    # empty/superset windows; geometric validity (per-axis bounds, z
    # clamping) is the KERNEL's per-pair cell-id test — which multi-row
    # (sparse-run) blocks need anyway to keep adjacent offsets'
    # overlapping windows from double counting.
    act = (plan.seg_len > 0)[:, None]
    lo = jnp.stack([plan.id_first + off - 1 for off in offs], axis=-1)
    hi = jnp.stack([plan.id_last + off + 1 for off in offs], axis=-1)
    lo = jnp.where(act, jnp.clip(lo, 0, spec.num_cells), spec.num_cells)
    hi = jnp.where(act, jnp.clip(hi, -1, spec.num_cells - 1), -1)
    starts = bounds[lo].astype(jnp.int32)
    ends = bounds[jnp.clip(hi + 1, 0, spec.num_cells)].astype(jnp.int32)
    lens = jnp.maximum(ends - starts, 0)
    own_lo = plan.own_lo.astype(jnp.int32)
    meta = SegMeta(
        wstart=starts,
        wlen=jnp.minimum(lens, window),
        iblk=(plan.seg_start // block).astype(jnp.int32),
        own=jnp.stack([own_lo, own_lo + plan.seg_len.astype(jnp.int32)], axis=1),
    )
    return meta, jnp.max(lens)


def _seg_sweep_kernel(tab_ref, ipack_ref, jpack_ref, out_ref, *, mode, spec,
                      params, bi, tile, n_i):
    """One program: lanes ``[lane0, lane0 + bi)`` of logical block ``b``.

    ``tab_ref`` row b = [wstart x rows | wlen x rows | i base | own_lo |
    own_hi] (see _run_sweep_seg).  Membership is the per-pair cell-id test
    alone: for stencil row r with i-independent id offset o_off(r), j is a
    candidate of i iff ``id_j - o_off(r)`` lies in i's z-clamped column
    range [lo_i, hi_i].  It assigns every j to at most ONE row per i (the
    rows' cell ranges are disjoint — also at grid edges, because
    GridSpec.strides pads each inner axis by a gap row), so overlapping
    windows of a multi-row block never double count; the spline clamps
    make the r2 < h^2 cutoff exact; and no mode needs a self-pair test
    (density/bvol fold the self W(0) term in, the gradient modes' self
    term is multiplied by dx = 0)."""
    rows, dim = spec.num_rows, spec.dim
    h = params.support_length
    k_sig = cubic_kernel_sigma(dim, h)
    strides = np.asarray(spec.strides)
    res_z = float(int(spec.res[-1]))
    o_offs = [
        float(np.dot(o, strides[: dim - 1])) if dim > 1 else 0.0
        for o in _row_offsets(spec)
    ]

    b = pl.program_id(0)
    lane0 = pl.program_id(1) * bi
    own_lo = tab_ref[b, 2 * rows + 1]
    own_hi = tab_ref[b, 2 * rows + 2]

    @pl.when((own_lo < lane0 + bi) & (own_hi > lane0))
    def _():
        base = tab_ref[b, 2 * rows] + lane0
        iota_i = jax.lax.broadcasted_iota(jnp.int32, (bi,), 0)
        imask = base + iota_i < n_i

        def irow(r):
            return plgpu.load(ipack_ref.at[r, pl.ds(base, bi)], mask=imask,
                              other=0.0)

        xi = [irow(_X + a) for a in range(dim)]
        ivals, bias = _ivals(mode, dim, params, irow)
        # per-i column bounds: z (fastest-axis cell coord) decoded from the
        # id (i32-exact: num_cells < 2^24 is enforced at bind)
        idf = irow(_ID)
        if dim > 1:
            zf = jax.lax.rem(idf.astype(jnp.int32),
                             jnp.int32(int(strides[-2]))).astype(jnp.float32)
        else:
            zf = idf
        lo_i = (idf - jnp.minimum(zf, 1.0))[:, None]
        hi_i = (idf + jnp.minimum(res_z - 1.0 - zf, 1.0))[:, None]
        tl = jax.lax.broadcasted_iota(jnp.int32, (tile,), 0)

        acc = tuple(jnp.zeros((bi,), jnp.float32)
                    for _ in range(_n_out(mode, dim)))
        for r in range(rows):
            start = tab_ref[b, r]
            end = start + tab_ref[b, rows + r]
            # tiles on the absolute j grid: aligned loads, and each j sits
            # in the same tile whichever block's window covers it — so a
            # per-i sum does not depend on how the array is cut into
            # blocks (the 1-D mesh reproduces the single card bitwise)
            a0 = start - jax.lax.rem(start, tile)
            n_t = jnp.where(end > start, pl.cdiv(end - a0, tile), 0)

            def body(t, acc, start=start, end=end, a0=a0, o_off=o_offs[r]):
                j0 = pl.multiple_of(a0 + t * tile, tile)
                jl = j0 + tl
                jm = (jl >= start) & (jl < end)
                loaded = {}

                def jrow(rr):
                    if rr not in loaded:
                        loaded[rr] = plgpu.load(
                            jpack_ref.at[rr, pl.ds(j0, tile)], mask=jm,
                            other=0.0)
                    return loaded[rr]

                idw = jrow(_ID)[None, :] - o_off
                valid = jm[None, :] & (idw >= lo_i) & (idw <= hi_i)
                terms = _pair_terms(mode, dim, h, params, ivals, xi, jrow,
                                    valid)
                return tuple(a + jnp.sum(t_, axis=1)
                             for a, t_ in zip(acc, terms))

            acc = jax.lax.fori_loop(0, n_t, body, acc)

        fin = _fin_scale(mode, k_sig, h)
        li = lane0 + iota_i
        own = (li >= own_lo) & (li < own_hi)
        for c, a in enumerate(acc):
            val = a * fin if bias is None else a * fin + bias[c]
            plgpu.store(out_ref.at[c, pl.ds(base, bi)], val, mask=own)


def _run_sweep_seg(pack, meta: "SegMeta", mode, spec, params, block,
                   interpret, active=None, ipack=None):
    """Run one seg sweep; returns the (C, N_i) COMPACT output (C = 1 for
    the scalar modes, dim otherwise), valid where SegPlan.back_valid.

    ``active``: optional (num_blocks,) i32 — blocks with 0 do no work and
    leave their out lanes as garbage (see :func:`active_blocks`); callers
    must consume the output only on rows of active blocks.

    ``ipack``: optional separate (16, N_i) i-side pack.  By default the
    i-slabs are block slices of ``pack`` itself (meta.iblk in j
    coordinates — the 1-D sharded path's offset trick).  The 2-D sharded
    path passes its LOCAL pack here: own rows interleave with halo rows in
    the id-merged extended j array, so they are not contiguous there;
    meta.iblk is then in LOCAL (ipack) coordinates, and the self-pair zero
    (dx bitwise 0) still holds because the own rows' values in ipack and
    the extended pack are copies of the same f32 values."""
    if mode not in _MODES:
        raise ValueError(f"unknown seg sweep mode {mode!r}")
    bi, tile, num_warps, num_stages = launch_config(mode, interpret)
    bi = min(bi, block)
    if block % bi:
        raise ValueError(f"block {block} is not a multiple of {bi} lanes")
    ipack = pack if ipack is None else ipack
    n_i = ipack.shape[1]
    own_hi = meta.own[:, 1]
    wlen = meta.wlen
    if active is not None:
        on = active[:, None] != 0
        wlen = jnp.where(on, wlen, 0)
        own_hi = jnp.where(on[:, 0], own_hi, meta.own[:, 0])
    tab = jnp.concatenate(
        [meta.wstart, wlen, (meta.iblk * block)[:, None],
         meta.own[:, :1], own_hi[:, None]], axis=1,
    ).astype(jnp.int32)
    n_out = -(-n_i // block) * block  # every block's i slab fits
    kern = functools.partial(
        _seg_sweep_kernel, mode=mode, spec=spec, params=params,
        bi=bi, tile=tile, n_i=n_i,
    )
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((_n_out(mode, spec.dim), n_out),
                                       jnp.float32),
        grid=(tab.shape[0], block // bi),
        interpret=interpret,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        name=f"seg_{mode}",
    )(tab, ipack, pack)
    return out[:, :n_i]


def density_sweep_seg(pack, meta: "SegMeta", spec, params, block,
                      interpret=False, active=None, ipack=None):
    """Seg-layout density sweep; COMPACT (n,) output — valid where
    SegPlan.back_valid (lanes no block owns hold garbage; with ``active``
    flags, only on rows of active blocks — consumers mask with the fluid
    row family, see active_blocks)."""
    return _run_sweep_seg(pack, meta, "density", spec, params, block,
                          interpret, active=active, ipack=ipack)[0]


def force_sweep_seg(pack, meta: "SegMeta", spec, params, block,
                    interpret=False, active=None, ipack=None):
    """Seg-layout fused force sweep (gravity included); COMPACT (n, dim)
    output — valid where SegPlan.back_valid (with ``active``: on
    active-block rows only — consumers mask with the fluid row family)."""
    return _run_sweep_seg(pack, meta, "force", spec, params, block,
                          interpret, active=active, ipack=ipack).T


def bvol_sweep_seg(pack, meta: "SegMeta", spec, params, block,
                   interpret=False, active=None, ipack=None):
    """Seg-layout boundary-volume denominator; COMPACT (n,) output —
    valid where SegPlan.back_valid (AND, when ``active`` block flags are
    given, only on rows of active blocks — callers consume bvol on
    boundary rows only, and bvol_active_blocks marks every block whose
    i-slab holds one)."""
    return _run_sweep_seg(pack, meta, "bvol", spec, params, block,
                          interpret, active=active, ipack=ipack)[0]


def reaction_sweep_seg(pack, meta: "SegMeta", spec, params, block,
                       interpret=False, ipack=None):
    """Seg-layout fluid->boundary reaction force; COMPACT (n, dim)
    output — valid where SegPlan.back_valid."""
    return _run_sweep_seg(pack, meta, "reaction", spec, params, block,
                          interpret, ipack=ipack).T


def force_react_sweep_seg(pack, meta: "SegMeta", spec, params, block,
                          interpret=False, active=None, ipack=None):
    """Fused force + reaction (rigid two-way coupling) in ONE seg pass:
    COMPACT (n, dim) output holding the fluid dv on fluid rows and the
    fluid->boundary reaction force on boundary rows (valid where
    SegPlan.back_valid; callers split by material mask — with ``active``
    flags use the fluid|boundary row family).  Per-pair arithmetic is
    identical to force_sweep_seg / reaction_sweep_seg."""
    return _run_sweep_seg(pack, meta, "force_react", spec, params, block,
                          interpret, active=active, ipack=ipack).T


def active_blocks(pack, meta: "SegMeta", block: int,
                  rows: tuple = (_BD,)) -> jax.Array:
    """(num_blocks,) i32 flags for a seg sweep's ``active``: 1 iff the seg
    block's i-slab [iblk*block, +block) holds a row with pack[r] > 0 for
    any r in ``rows``.  EXACT whenever the sweep's output is consumed only
    on such rows (every consumer masks with back_valid & its row family):
    bvol on boundary rows (rows=(_BD,)), density/force on fluid rows
    (rows=(_FL,)), force_react on fluid|boundary rows (rows=(_FL, _BD)).
    Constant within an R-group (material and sorted order don't change
    between rebuilds), cheap enough to recompute per substep (one (n,)
    compare + reshape-any + gather over ~1e3 blocks)."""
    m = pack[rows[0]] > 0.0
    for r in rows[1:]:
        m = m | (pack[r] > 0.0)
    nb = -(-pack.shape[1] // block)
    mp = jnp.pad(m, (0, nb * block - pack.shape[1]))
    slab_any = jnp.any(mp.reshape(nb, block), axis=1)
    return jnp.take(slab_any, meta.iblk, fill_value=False).astype(jnp.int32)


def bvol_active_blocks(pack, meta: "SegMeta", block: int) -> jax.Array:
    """active_blocks for the bvol sweep (boundary rows only)."""
    return active_blocks(pack, meta, block, rows=(_BD,))
