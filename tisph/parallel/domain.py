"""Sharded WCSPH step: spatial domain decomposition via Mesh + shard_map.

Design (see package docstring): the globally cell-sorted particle array is
sharded evenly over the mesh axis; shards are spatial slabs because flat
cell ids are x-major.  One step =

  1. [global, SPMD]  flat cell ids -> distributed resort of the whole SoA
     (this both rebuilds the neighbor structure AND migrates particles
     between shards — the distributed generalisation of the reference's
     counting-sort resort, partice_systemv4.py:206-258).  Default path is
     the edge-exchange resort (``_exchange_resort``: depth-E edge
     ppermutes + per-shard local sort + fixed cut, O(E) bytes/shard),
     which is exact whenever no particle's global rank moved more than E
     rows since the last rebuild and falls back to the stock multi-operand
     ``lax.sort`` (O(N) all_gather of the key array) behind a
     seam-monotonicity guard that provably catches every violation.
  2. [shard_map]     ppermute halo exchange of the sorted array's edge
     slices (one fixed-width slice to each neighbor)
  3. [shard_map]     blocked neighbor sweeps: local i-particles against the
     halo-extended candidate array (density)
  4. [local]         Tait EOS
  5. [shard_map]     second halo exchange of (density, pressure) only, then
     the fused force sweep
  6. [local]         symplectic Euler + domain clamp

Collectives per step: 4 ppermutes (2 halo directions x 2 exchanges) plus
whatever XLA emits for the distributed sort.

On the pallas sweeps the step is split build/apply exactly like the
single-chip solver (WCSPH._seg_build / _seg_apply): the build phase runs
the distributed sort and the per-shard seg plan + window metadata inside
one shard_map and returns them as sharded arrays; the apply phase
re-exchanges only field VALUES each substep against the cached structure.
``SweepConfig.resort_every = R`` then amortizes the whole rebuild over R
substeps (SolverBase.rollout picks the amortized path up automatically via
the _seg_build/_seg_apply protocol).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tisph.config import SceneConfig, SolverParams
from tisph.models.state import SimState, MATERIAL_INVALID
from tisph.models.solver_base import SolverBase
from tisph.ops import forces as F
from tisph.ops import grid as gridops
from tisph.ops.eos import tait_pressure
from tisph.ops.neighbors import (
    NeighborData, SweepConfig, neighbor_sweep_blocked, platform_sweep_impl,
)


def make_mesh(n_devices: int | None = None, axis: str = "shard") -> Mesh:
    """1-D mesh over the default backend's devices, in ``jax.devices()``
    order.  Too few devices is an error: a CPU run gets more with
    XLA_FLAGS=--xla_force_host_platform_device_count=N; an accelerator
    backend never falls back to CPU devices."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, the {devs[0].platform} backend "
                f"has {len(devs)}"
                + (" (set XLA_FLAGS=--xla_force_host_platform_device_count=N)"
                   if devs[0].platform == "cpu" else "")
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


_FIELD_KEYS = ("x", "v", "density", "pressure", "mass", "volume", "material")


class ShardedWCSPH(SolverBase):
    """WCSPH over a 1-D device mesh.  Same physics (shares the pair-kernel
    factories with the single-chip solver), sharded execution."""

    def __init__(
        self,
        scene: SceneConfig,
        mesh: Mesh,
        compat: str = "reference",
        params: SolverParams | None = None,
        sweep_cfg: SweepConfig | None = None,
        halo: int | None = None,
        resort: str = "exchange",
        resort_edge: int | None = None,
        boundary_mode: str | None = None,
    ):
        if boundary_mode is None:
            # rigid scenes need per-substep Akinci volume recomputes (the
            # bodies move); auto-select like run_scene does for WCSPHRigid
            boundary_mode = (
                "per_step"
                if any(rb.is_dynamic for rb in scene.rigid_bodies)
                else "static"
            )
        super().__init__(scene, compat=compat, params=params,
                         sweep_cfg=sweep_cfg, boundary_mode=boundary_mode)
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_shards = mesh.devices.size
        self.halo = halo  # defaults to window_cap at bind
        self.halo_path: str | None = None  # 'ppermute' | 'all_gather' (set at trace)
        if resort not in ("exchange", "global"):
            raise ValueError(f"resort must be 'exchange' or 'global', got {resort!r}")
        # 'exchange': edge-exchange resort with stock-sort fallback on the
        # seam guard (the scaling fix for XLA's all-gathering distributed
        # sort — docs/design.md 1e9 bridge); 'global': stock lax.sort only.
        self.resort = resort
        # edge depth in rows (None = auto from the grid geometry at trace)
        self.resort_edge = resort_edge
        self._sharding = NamedSharding(mesh, P(self.axis))
        self._replicated = NamedSharding(mesh, P())

    # ------------------------------------------------------------------
    def bind(self, state: SimState) -> SimState:
        """Resolve caps, precompute static boundary volumes, pad capacity to
        a shard-divisible size, and device_put with the particle-axis
        sharding."""
        if self.spec is None or self.sweep_cfg is None:
            probe = self.spec if self.spec is not None else self._make_spec(run_cap=8)
            block = self.sweep_cfg.block_size if self.sweep_cfg is not None else 128
            run_len, window, _ = gridops.measure_caps_device(state, probe, block)
        if self.spec is None:
            self.spec = self._make_spec(max(8, -(-int(run_len * 1.5) // 8) * 8))
        if self.sweep_cfg is None:
            wcap = max(128, -(-int(window * 1.5) // 128) * 128)
            self.sweep_cfg = SweepConfig(
                impl=platform_sweep_impl(self.mesh.devices.ravel()[0].platform),
                block_size=block, window_cap=wcap,
            )
        if self.sweep_cfg.impl == "pallas" and self.spec.num_cells >= 2**24:
            raise ValueError("pallas sweep needs num_cells < 2**24")
        if self.boundary_mode == "static":
            state = self._precompute_boundary_volumes(state)

        # pad capacity so each shard gets an equal, block-divisible chunk
        unit = self.n_shards * self.sweep_cfg.block_size
        cap = int(-(-state.capacity // unit) * unit)
        if cap != state.capacity:
            pad = cap - state.capacity

            def pad_leaf(a):
                if a.ndim == 0:
                    return a
                fill = MATERIAL_INVALID if a.dtype in (jnp.int32, jnp.int64) else 0
                return jnp.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1), constant_values=fill)

            state = jax.tree.map(pad_leaf, state)

        self._shard_rows = cap // self.n_shards
        if self.halo is None:
            # halo depth in rows: furthest stencil reach across any shard
            # boundary (measured on device; grows with per-x-slab particle
            # counts), padded with 2x slack and capped at the whole
            # remainder of the array
            _, _, reach = gridops.measure_caps_device(
                state, self.spec, self.sweep_cfg.block_size, self._shard_rows
            )
            h = max(128, -(-int(reach * 2.0) // 128) * 128)
            self.halo = min(h, (self.n_shards - 1) * self._shard_rows) if self.n_shards > 1 else 128
        cfg = self.sweep_cfg
        if cfg.impl == "pallas" and cfg.pad_capacity <= 0:
            # per-SHARD seg block capacity: local slab blocks + anchor
            # fragmentation headroom (run() regrows on occ_rowpad overflow)
            import dataclasses as _dc

            blocks = -(-self._shard_rows // cfg.block_size)
            self.sweep_cfg = _dc.replace(
                cfg,
                pad_capacity=(int(blocks * 1.3) + 256) * cfg.block_size,
            )
        # halo must stay a multiple of the block size: seg i-slab indices
        # are offset by off // block (both extension paths)
        if self.halo % self.sweep_cfg.block_size:
            b = self.sweep_cfg.block_size
            self.halo = -(-self.halo // b) * b
        if self.resort == "exchange" and self.n_shards > 1:
            # edge depth default = the halo depth: both bound "rows within
            # ~a cell-width of a seam", which is the scale of inter-rebuild
            # rank shift (crossing one x-cell boundary re-ranks a particle
            # past at most ~one x-column of particles); the seam guard +
            # run()'s adaptive deepening cover flows that beat the bound
            e = self.resort_edge if self.resort_edge is not None else self.halo
            e = max(128, -(-int(e) // 128) * 128)
            self.resort_edge = int(min(e, self._shard_rows))
        return self.shard_state(state)

    def shard_state(self, state: SimState) -> SimState:
        return jax.tree.map(
            lambda a: jax.device_put(
                a, self._sharding if getattr(a, "ndim", 0) >= 1 else self._replicated
            ),
            state,
        )

    def _hops(self) -> int:
        return max(1, -(-self.halo // self._shard_rows))

    # ------------------------------------------------------------------
    def _halo_exchange(self, arrs: dict, h: int, hops: int) -> dict:
        """Return halo-extended copies: concat(left_halo[h], arr, right_halo[h]).

        A particle's stencil candidates can sit up to ~one x-cell-row of
        particles away in sorted order, so the halo depth ``h`` (measured at
        bind via grid.measure_caps_device) may exceed one neighbor's chunk.
        The exchange therefore runs ``hops`` ppermute rounds, each shifting
        full chunks one position around the (non-wrapping) ring, and slices
        the needed h rows from the concatenation.  The 'ids' channel of
        never-received edge chunks is neutralised to -1 (left, below every
        real id) / num_cells (right, the inactive sentinel) so window
        searchsorted stays correct and masks select nothing there.
        """
        ax = self.axis
        d = self.n_shards
        fwd = [(i, i + 1) for i in range(d - 1)]  # shift +1: recv from left
        bwd = [(i + 1, i) for i in range(d - 1)]  # shift -1: recv from right
        idx = jax.lax.axis_index(ax)

        def shift(a, perm):
            return jax.lax.ppermute(a, ax, perm) if d > 1 else jnp.zeros_like(a)

        out = {}
        keys = list(arrs.keys())
        left_chunks: dict[str, list] = {k: [] for k in keys}
        right_chunks: dict[str, list] = {k: [] for k in keys}
        cur_l = dict(arrs)
        cur_r = dict(arrs)
        for hop in range(1, hops + 1):
            for k in keys:
                cur_l[k] = shift(cur_l[k], fwd)
                cur_r[k] = shift(cur_r[k], bwd)
            # neutralise chunks that fell off the edge
            l_ids = jnp.where(idx - hop >= 0, cur_l["ids"], -1)
            r_ids = jnp.where(idx + hop < d, cur_r["ids"], self.spec.num_cells)
            for k in keys:
                lv = cur_l[k] if k != "ids" else l_ids
                rv = cur_r[k] if k != "ids" else r_ids
                left_chunks[k].insert(0, lv)   # order: ... d-2, d-1
                right_chunks[k].append(rv)     # order: d+1, d+2 ...
        for k in keys:
            left = jnp.concatenate(left_chunks[k], axis=0)[-h:]
            right = jnp.concatenate(right_chunks[k], axis=0)[:h]
            out[k] = jnp.concatenate([left, arrs[k], right], axis=0)
        return out

    def _extend(self, arrs: dict, hn: int, hops: int, shard_rows: int):
        """Halo-extend ``arrs`` (must contain an 'ids' channel); returns
        (ext_dict, i_offset).

        Normal path: k-hop ppermute halo (hops small).  When the halo would
        need more than 2 hops (tiny shards relative to the stencil reach —
        dry runs, small scenes), a single tiled all_gather of the whole
        sorted array is cheaper than a deep ppermute chain; the i side is
        then my chunk at offset axis_index * shard_rows.  The branch is
        static (hops is host-resolved), recorded in ``self.halo_path``.
        """
        if hops <= 2:
            self.halo_path = "ppermute"
            return self._halo_exchange(arrs, hn, hops), hn
        self.halo_path = "all_gather"
        gathered = {
            k: jax.lax.all_gather(v, self.axis, tiled=True)
            for k, v in arrs.items()
        }
        off = jax.lax.axis_index(self.axis) * shard_rows
        return gathered, off

    def _cover_flag(self, ids_l, ids_e, ranges, hops):
        """Halo-reach overflow flag (pmax'd over shards): trips when some
        required cell range of a LOCAL particle reaches past the ids the
        halo-extended array actually covers (fluid migrated across slabs
        since bind measured the reach).  Left-covered iff ids_e[0] < min
        q_lo (every global id >= q_lo then lies inside); right-covered iff
        ids_e[-1] > max q_hi.  Neutralised edge chunks (-1 / num_cells)
        make the global head and tail trivially covered."""
        spec, ax = self.spec, self.axis
        full_cover = hops > 2 or hops >= self.n_shards - 1
        if full_cover:
            # all_gather path (or a halo deep enough to reach every other
            # shard): coverage is total by construction — the edge test
            # below would false-trip on the shards holding the global
            # head/tail (their stencils reach past the lowest/highest real
            # ids) and livelock regrow_halo.
            return jnp.zeros((), jnp.int32)
        act = (ids_l < spec.num_cells)[:, None]
        valid = act & (ranges[..., 0] <= ranges[..., 1])
        q_lo = jnp.where(valid, ranges[..., 0], spec.num_cells)
        q_hi = jnp.where(valid, ranges[..., 1], -1)
        lo_min = jnp.min(q_lo)
        hi_max = jnp.max(q_hi)
        halo_flag = (
            ((lo_min < spec.num_cells) & (ids_e[0] >= lo_min))
            | ((hi_max >= 0) & (ids_e[-1] <= hi_max))
        ).astype(jnp.int32)
        if self.n_shards > 1:
            halo_flag = jax.lax.pmax(halo_flag, ax)
        return halo_flag

    def _sort_payload(self, state: SimState):
        """Flatten the per-particle SoA into 1-D sort-operand columns.
        Returns (cols, layout) where layout maps each column back to its
        (field name, component) slot."""
        cols: list[jax.Array] = []
        layout: list[tuple[str, int]] = []

        def add(name, a):
            if a.ndim == 1:
                cols.append(a)
                layout.append((name, -1))
            else:
                for c in range(a.shape[1]):
                    cols.append(a[:, c])
                    layout.append((name, c))

        add("x", state.x)
        add("v", state.v)
        add("density", state.density)
        add("pressure", state.pressure)
        add("mass", state.mass)
        add("volume", state.volume)
        add("material", state.material)
        add("color", state.color)
        add("object_id", state.object_id)
        return cols, layout

    def _payload_to_state(self, state: SimState, sorted_cols, layout) -> SimState:
        """Rebuild the SoA fields from sorted payload columns and re-constrain
        the particle-axis sharding."""
        rebuilt: dict[str, list[jax.Array]] = {}
        for (name, c), col in zip(layout, sorted_cols):
            rebuilt.setdefault(name, []).append(col)
        new_fields = {
            name: (cs[0] if len(cs) == 1 else jnp.stack(cs, axis=1))
            for name, cs in rebuilt.items()
        }
        state = dataclasses.replace(state, **new_fields)
        return jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(
                a, self._sharding if getattr(a, "ndim", 0) >= 1 else self._replicated
            ),
            state,
        )

    def _resort(self, state: SimState):
        """Phase A dispatch: rebuild the global cell-sorted order (which is
        also the inter-shard particle migration).  'exchange' = the edge-
        exchange resort with a guarded stock-sort fallback (O(edge) bytes
        per shard instead of the stock distributed sort's full-array
        all_gather); 'global' = stock ``lax.sort`` only."""
        if self.resort == "exchange" and self.n_shards > 1:
            return self._exchange_resort(state)
        return self._global_resort(state)

    def _global_resort(self, state: SimState):
        """Stock distributed resort: multi-operand ``lax.sort`` by flat cell
        id over the sharded arrays (XLA lowers this to an all_gather of the
        key array plus payload redistribution).  Returns (sorted state with
        the particle-axis sharding re-constrained, sorted_ids)."""
        spec = self.spec
        coords = gridops.cell_coords(state.x, spec)
        ids = gridops.flat_cell_ids(coords, state.material, spec)
        cols, layout = self._sort_payload(state)
        sorted_all = jax.lax.sort((ids, *cols), num_keys=1, is_stable=True)
        state = self._payload_to_state(state, sorted_all[1:], layout)
        sorted_ids = jax.lax.with_sharding_constraint(sorted_all[0], self._sharding)
        return state, sorted_ids

    def _exchange_resort(self, state: SimState):
        """Edge-exchange distributed resort (the 1e9-bridge scaling fix for
        XLA's all-gathering distributed sort — docs/design.md).

        The array is already globally sorted from the previous rebuild and
        particles move well under a cell per substep, so each particle's
        GLOBAL RANK shifts by a bounded number of rows between rebuilds.
        When that bound is ``E = self.resort_edge``:

          1. each shard ppermutes its edge slices to its ring neighbors
             (left neighbor's last E rows, right neighbor's first E rows —
             2 ppermutes of (E, cols) bytes, independent of N),
          2. locally sorts the extended [prev-edge ∥ own ∥ next-edge] array
             of rps+2E rows by the UNIQUE total key (cell id, previous
             global index),
          3. keeps extended ranks [E, E+rps).

        Exactness: a particle destined for global rank q ∈ [s·rps,
        (s+1)·rps) has every global predecessor w (rank(w) < q) inside
        shard s's extension except exactly the s·rps − E rows with previous
        position < s·rps − E (|rank−pos| ≤ E pins them all before q), so its
        local extended rank is q − s·rps + E — the fixed cut recovers the
        exact stable global sort (missing edges at the mesh ends are filled
        with −1 / i32max key sentinels so the cut stays uniform).

        Guard: the bound E can be violated (first rebuild after bind, blast
        waves).  Each shard checks the seam against its left neighbor's last
        kept key; all seams strictly increasing ⟹ the concatenation is N
        strictly-increasing copies of input keys ⟹ a permutation ⟹ THE
        stable sort.  Any violation therefore trips some seam (fixed shard
        sizes: a lost row forces a duplicated row, and a duplicate's two
        copies bound a non-increasing seam); trips select the stock
        ``lax.sort`` result via ``lax.cond`` and count in ``occ_resort``
        (run() deepens the edge when trips persist)."""
        spec, ax = self.spec, self.axis
        d, rps, E = self.n_shards, self._shard_rows, self.resort_edge
        coords = gridops.cell_coords(state.x, spec)
        ids = gridops.flat_cell_ids(coords, state.material, spec)
        cols, layout = self._sort_payload(state)
        n_ops = 1 + len(cols)
        fwd = [(i, i + 1) for i in range(d - 1)]
        bwd = [(i + 1, i) for i in range(d - 1)]
        i32max = jnp.int32(np.iinfo(np.int32).max)
        axis_spec = P(ax)

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(axis_spec,) * n_ops,
            out_specs=(axis_spec,) * n_ops + (P(),),
            check_vma=False,
        )
        def exchange_shard(ids_l, *cols_l):
            idx = jax.lax.axis_index(ax)
            src_l = idx * rps + jax.lax.iota(jnp.int32, rps)
            chans = [ids_l, src_l, *cols_l]
            dts = [c.dtype for c in chans]

            def f32(c):  # lossless bitcast so edges ride ONE ppermute each
                return (c if c.dtype == jnp.float32
                        else jax.lax.bitcast_convert_type(c, jnp.float32))

            tail = jnp.stack([f32(c[-E:]) for c in chans], axis=1)
            head = jnp.stack([f32(c[:E]) for c in chans], axis=1)
            left = jax.lax.ppermute(tail, ax, fwd)   # left neighbor's last E
            right = jax.lax.ppermute(head, ax, bwd)  # right neighbor's first E
            ext = []
            for k, dt in enumerate(dts):
                lc, rc = left[:, k], right[:, k]
                if dt != jnp.float32:
                    lc = jax.lax.bitcast_convert_type(lc, dt)
                    rc = jax.lax.bitcast_convert_type(rc, dt)
                if k == 0:  # key sentinels for the mesh-end missing edges
                    lc = jnp.where(idx > 0, lc, jnp.int32(-1))
                    rc = jnp.where(idx < d - 1, rc, i32max)
                ext.append(jnp.concatenate([lc, chans[k], rc], axis=0))
            # total key (cell id, prev global index) is unique over real
            # rows, so the unstable sort is deterministic; the only equal
            # keys are the discarded sentinel fills
            s = jax.lax.sort(tuple(ext), num_keys=2, is_stable=False)
            kept = [a[E:E + rps] for a in s]
            k_ids, k_src = kept[0], kept[1]
            last = jnp.stack([k_ids[-1], k_src[-1]])
            prev = jax.lax.ppermute(last, ax, fwd)
            seam_ok = (
                (idx == 0)
                | (prev[0] < k_ids[0])
                | ((prev[0] == k_ids[0]) & (prev[1] < k_src[0]))
            )
            bad = jax.lax.pmax((~seam_ok).astype(jnp.int32), ax)
            return (k_ids, *kept[2:], bad)

        *exch, bad = exchange_shard(ids, *cols)
        exch = tuple(exch)
        sorted_all = jax.lax.cond(
            bad > 0,
            lambda ops: jax.lax.sort(ops, num_keys=1, is_stable=True),
            lambda ops: exch,
            (ids, *cols),
        )
        state = dataclasses.replace(
            state,
            occ_resort=jnp.asarray(state.occ_resort, jnp.int32)
            + (bad > 0).astype(jnp.int32),
        )
        state = self._payload_to_state(state, sorted_all[1:], layout)
        sorted_ids = jax.lax.with_sharding_constraint(sorted_all[0], self._sharding)
        return state, sorted_ids

    # ------------------------------------------------------------------
    # seg layout: build/apply split (cached structure, resort_every
    # amortization — the sharded analog of WCSPH._seg_build/_seg_apply)
    # ------------------------------------------------------------------
    def _seg_build(self, state: SimState):
        """Distributed resort + per-shard seg structure build.  Returns
        (state, cache); the cache — per-shard SegMeta + back maps + the
        sorted ids, all sharded along their leading axes — stays valid for
        a few substeps of motion (SweepConfig.resort_every)."""
        from tisph.ops.pallas import sweeps as ps

        spec, scfg = self.spec, self.sweep_cfg
        ax = self.axis
        hn, shard_rows = self.halo, self._shard_rows
        hops = self._hops()
        block = scfg.block_size
        block_cap = scfg.pad_capacity // block
        axis_spec = P(ax)

        state, sorted_ids = self._resort(state)

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(axis_spec,),
            out_specs=(
                ps.SegMeta(*(axis_spec,) * len(ps.SegMeta._fields)),
                axis_spec, P(), P(),
            ),
            check_vma=False,
        )
        def build_shard(ids_l):
            # the plan partitions the LOCAL slab (a contiguous chunk of the
            # global sorted array — partially cut boundary rows just become
            # partial anchors), while windows search the halo-EXTENDED ids.
            # i-slabs are addressed inside the extended pack by offsetting
            # the plan's block indices (off is a multiple of block on both
            # extension paths), which also makes the kernel's self-pair
            # `own` index land in j coordinates.
            bounds_l = gridops.csr_bounds_hist(ids_l, spec)
            plan = gridops.seg_plan(ids_l, spec, block, block_cap, bounds=bounds_l)
            ext, off = self._extend({"ids": ids_l}, hn, hops, shard_rows)
            ids_e = ext["ids"]
            bounds_e = gridops.csr_bounds_hist(ids_e, spec)
            meta, need = ps.seg_block_meta(
                plan, ids_e, spec, block, scfg.window_cap, bounds=bounds_e,
            )
            meta = meta._replace(iblk=meta.iblk + off // block)
            need = need.astype(jnp.int32)
            pad_need = (plan.need_blocks * block).astype(jnp.int32)
            if self.n_shards > 1:
                need = jax.lax.pmax(need, ax)
                pad_need = jax.lax.pmax(pad_need, ax)
            return meta, plan.back_valid, need, pad_need

        meta, back_valid, need, pad_need = build_shard(sorted_ids)
        state = self._track_occ(state, need)
        state = dataclasses.replace(
            state,
            occ_rowpad=jnp.maximum(
                jnp.asarray(state.occ_rowpad, jnp.int32), pad_need
            ),
        )
        return state, (meta, back_valid, sorted_ids)

    def _seg_apply(self, state: SimState, cache) -> SimState:
        """One physics substep against the (possibly stale) cached seg
        structure: two value-only halo exchanges + the seg pallas sweeps.
        Pair-membership staleness bound: identical to the single-chip
        WCSPH._seg_apply (sort-time id test + current-position r2).

        The cached sorted ids ride each exchange as one extra payload row
        (~1/9 of the halo bytes) instead of being cached in extended form:
        on the all_gather fallback path an extended-ids cache would
        materialise n_shards full copies of the global id array, and on
        the ppermute path the id row shares the value rows' pipeline, so
        the re-exchange costs no extra collective latency."""
        from tisph.ops.pallas import sweeps as ps

        spec, params, scfg = self.spec, self.params, self.sweep_cfg
        ax = self.axis
        hn, shard_rows = self.halo, self._shard_rows
        hops = self._hops()
        meta, back_valid, sorted_ids = cache
        axis_spec = P(ax)
        def sweep_shard(mode, ids_l, meta_c, bval, *fields):
            f_local = dict(zip(_FIELD_KEYS, fields))
            n_local = f_local["x"].shape[0]
            ext, off = self._extend(
                {**f_local, "ids": ids_l}, hn, hops, shard_rows
            )
            ids_e = ext["ids"]
            if mode == "density":
                # positions are identical in both substep sweeps (advect
                # runs after force), so the halo-reach flag and its
                # (n, rows, 2) range build run ONCE per substep here and
                # the force sweep reuses the result
                coords_l = gridops.cell_coords(f_local["x"], spec)
                ranges = gridops.cell_target_ranges(coords_l, spec)
                halo_flag = self._cover_flag(ids_l, ids_e, ranges, hops)
            else:
                halo_flag = jnp.int32(0)
            pack_ext = ps.pack_state(
                ext["x"], ext["v"], ext["density"], ext["pressure"],
                ext["mass"], ext["volume"], ext["material"], ids_e, params,
            )
            fn = {"density": ps.density_sweep_seg,
                  "force": ps.force_sweep_seg,
                  "bvol": ps.bvol_sweep_seg}[mode]
            # COMPACT output over the extended array; this shard's rows
            # start at ``off`` (the meta's iblk carries the same offset)
            out_c = fn(pack_ext, meta_c, spec, params, scfg.block_size,
                       interpret=scfg.interpret)
            out_l = jax.lax.dynamic_slice_in_dim(out_c, off, n_local, axis=0)
            fluid = f_local["material"] == 1
            if mode == "density":
                keep = bval & fluid
                res = jnp.where(keep, out_l, f_local["density"])
            elif mode == "bvol":
                bd = f_local["material"] == 0
                res = jnp.where(bval & bd,
                                1.0 / jnp.maximum(out_l, 1e-10),
                                f_local["volume"])
            else:
                keep = (bval & fluid)[:, None]
                res = jnp.where(keep, out_l, 0.0)
            return res, halo_flag

        meta_spec = ps.SegMeta(*(axis_spec,) * len(ps.SegMeta._fields))
        in_specs = (
            (axis_spec, meta_spec, axis_spec)
            + (axis_spec,) * len(_FIELD_KEYS)
        )

        if self.boundary_mode == "per_step":
            # recompute the Akinci boundary volumes every substep, exactly
            # like the single-chip plain step (models/wcsph.py: the
            # per_step bvol sweep inside _seg_apply_pack) — without this,
            # boundary rows would silently keep build_state's uniform
            # volume0 forever (bind skips the static precompute here)
            @partial(jax.shard_map, mesh=self.mesh, in_specs=in_specs,
                     out_specs=(axis_spec, P()), check_vma=False)
            def bvol_shard(ids_l, meta_c, bval, *fields):
                return sweep_shard("bvol", ids_l, meta_c, bval, *fields)

            f = F.state_fields(state)
            volume, _ = bvol_shard(
                sorted_ids, meta, back_valid,
                *[f[k] for k in _FIELD_KEYS],
            )
            state = dataclasses.replace(state, volume=volume)

        @partial(jax.shard_map, mesh=self.mesh, in_specs=in_specs,
                 out_specs=(axis_spec, P()), check_vma=False)
        def density_shard(ids_l, meta_c, bval, *fields):
            return sweep_shard("density", ids_l, meta_c, bval, *fields)

        f = F.state_fields(state)
        density, hflag_d = density_shard(
            sorted_ids, meta, back_valid,
            *[f[k] for k in _FIELD_KEYS],
        )
        rho, pressure = tait_pressure(
            density, params.density0, params.stiffness, params.exponent
        )
        state = dataclasses.replace(state, density=rho, pressure=pressure)

        @partial(jax.shard_map, mesh=self.mesh, in_specs=in_specs,
                 out_specs=(axis_spec, P()), check_vma=False)
        def force_shard(ids_l, meta_c, bval, *fields):
            return sweep_shard("force", ids_l, meta_c, bval, *fields)

        f = F.state_fields(state)
        d_velocity, hflag_f = force_shard(
            sorted_ids, meta, back_valid,
            *[f[k] for k in _FIELD_KEYS],
        )

        state = dataclasses.replace(
            state,
            occ_halo=jnp.maximum(
                jnp.asarray(state.occ_halo, jnp.int32),
                jnp.maximum(hflag_d, hflag_f).astype(jnp.int32),
            ),
        )
        state = F.advect(state, d_velocity, params)
        return F.enforce_domain_boundary(state, params)

    # ------------------------------------------------------------------
    # dynamic rigid bodies over the mesh (two-way coupling, VERDICT r4 #3)
    # ------------------------------------------------------------------
    def init_rigid(self, state: SimState):
        from tisph.models.rigid import make_rigid_state

        return make_rigid_state(state, self.scene)

    def _coupled_step_fn(self, carry):
        state, rigid = carry
        state, cache = self._seg_build(state)
        return self._coupled_apply((state, rigid), cache)

    def _coupled_apply(self, carry, cache):
        """One coupled physics substep on the sharded seg path: the three
        sweeps (per-substep Akinci boundary volume, density, fused
        force+reaction — models/wcsph_rigid.py's pipeline) run as the
        usual halo-extended per-shard kernels, and the per-body
        force/torque reductions simply run on the SHARDED global arrays
        OUTSIDE shard_map — the masked ``jnp.sum`` over the particle axis
        lowers to per-shard partial sums + an all-reduce under GSPMD, so
        the 'psum across shards' of VERDICT r4 #3 is the compiler's
        insertion, not hand-written collectives.  RigidState is
        replicated (O(bodies) scalars)."""
        from tisph.models.rigid import integrate_rigid_fields
        from tisph.ops.pallas import sweeps as ps

        state, rigid = carry
        spec, params, scfg = self.spec, self.params, self.sweep_cfg
        if scfg.impl != "pallas":
            raise NotImplementedError(
                "sharded rigid coupling runs on the pallas sweeps only"
            )
        if self.boundary_mode != "per_step":
            raise ValueError("dynamic rigid bodies need boundary_mode="
                             "'per_step' (auto-selected for rigid scenes)")
        ax = self.axis
        hn, shard_rows = self.halo, self._shard_rows
        hops = self._hops()
        meta, back_valid, sorted_ids = cache
        axis_spec = P(ax)
        def sweep_shard(mode, ids_l, meta_c, bval, *fields):
            f_local = dict(zip(_FIELD_KEYS, fields))
            n_local = f_local["x"].shape[0]
            ext, off = self._extend(
                {**f_local, "ids": ids_l}, hn, hops, shard_rows
            )
            ids_e = ext["ids"]
            if mode == "bvol":
                # positions are identical in all three sweeps of a substep
                # (advect runs after force): flag halo reach once here
                coords_l = gridops.cell_coords(f_local["x"], spec)
                ranges = gridops.cell_target_ranges(coords_l, spec)
                halo_flag = self._cover_flag(ids_l, ids_e, ranges, hops)
            else:
                halo_flag = jnp.int32(0)
            pack_ext = ps.pack_state(
                ext["x"], ext["v"], ext["density"], ext["pressure"],
                ext["mass"], ext["volume"], ext["material"], ids_e, params,
            )
            fn = {"bvol": ps.bvol_sweep_seg,
                  "density": ps.density_sweep_seg,
                  "force_react": ps.force_react_sweep_seg}[mode]
            out_c = fn(pack_ext, meta_c, spec, params, scfg.block_size,
                       interpret=scfg.interpret)
            out_l = jax.lax.dynamic_slice_in_dim(out_c, off, n_local, axis=0)
            fluid = f_local["material"] == 1
            bd = f_local["material"] == 0
            if mode == "bvol":
                res = jnp.where(bval & bd,
                                1.0 / jnp.maximum(out_l, 1e-10),
                                f_local["volume"])
            elif mode == "density":
                res = jnp.where(bval & fluid, out_l, f_local["density"])
            else:  # fused dv (fluid rows) + reaction (boundary rows)
                res = jnp.where((bval & (fluid | bd))[:, None], out_l, 0.0)
            return res, halo_flag

        meta_spec = ps.SegMeta(*(axis_spec,) * len(ps.SegMeta._fields))
        in_specs = (
            (axis_spec, meta_spec, axis_spec)
            + (axis_spec,) * len(_FIELD_KEYS)
        )

        def make_shard(mode):
            @partial(jax.shard_map, mesh=self.mesh, in_specs=in_specs,
                     out_specs=(axis_spec, P()), check_vma=False)
            def shard(ids_l, meta_c, bval, *fields):
                return sweep_shard(mode, ids_l, meta_c, bval, *fields)
            return shard

        f = F.state_fields(state)
        volume, hflag_b = make_shard("bvol")(
            sorted_ids, meta, back_valid, *[f[k] for k in _FIELD_KEYS],
        )
        state = dataclasses.replace(state, volume=volume)

        f = F.state_fields(state)
        density, _ = make_shard("density")(
            sorted_ids, meta, back_valid, *[f[k] for k in _FIELD_KEYS],
        )
        rho, pressure = tait_pressure(
            density, params.density0, params.stiffness, params.exponent
        )
        state = dataclasses.replace(state, density=rho, pressure=pressure)

        f = F.state_fields(state)
        out, _ = make_shard("force_react")(
            sorted_ids, meta, back_valid, *[f[k] for k in _FIELD_KEYS],
        )
        fluid = state.fluid_mask[:, None]
        d_velocity = jnp.where(fluid, out, 0.0)
        reactions = jnp.where(state.boundary_mask[:, None], out, 0.0)

        state = dataclasses.replace(
            state,
            occ_halo=jnp.maximum(
                jnp.asarray(state.occ_halo, jnp.int32),
                hflag_b.astype(jnp.int32),
            ),
        )
        state = F.advect(state, d_velocity, params)
        x, v, rigid = integrate_rigid_fields(
            state.x, state.v, state.mass, state.object_id,
            state.boundary_mask, rigid, reactions, params,
        )
        state = dataclasses.replace(state, x=x, v=v)
        return F.enforce_domain_boundary(state, params), rigid

    def step_coupled(self, state: SimState, rigid):
        if self.spec is None:
            state = self.bind(state)
        if getattr(self, "_coupled_jit", None) is None:
            self._coupled_jit = jax.jit(self._coupled_step_fn)
        return self._coupled_jit((state, rigid))

    def rollout_coupled(self, state: SimState, rigid, num_steps: int):
        """``num_steps`` sharded coupled steps in one dispatch; with
        ``resort_every = R > 1`` the distributed rebuild runs once per
        R-group (the moving-boundary staleness argument of
        WCSPHRigid._coupled_apply extends unchanged — the id test uses
        cached sort-time ids on both sides and rigid motion is
        CFL-bounded)."""
        if self.spec is None:
            state = self.bind(state)
        R = self._amortize_R()
        if getattr(self, "_coupled_roll_jit", None) is None:
            if R > 1:
                def _roll(carry, n):
                    def outer(i, c):
                        st, cache = self._seg_build(c[0])
                        k = jnp.minimum(R, n - i * R)
                        return jax.lax.fori_loop(
                            0, k,
                            lambda _, c2: self._coupled_apply(c2, cache),
                            (st, c[1]),
                        )
                    return jax.lax.fori_loop(0, -(-n // R), outer, carry)
            else:
                def _roll(carry, n):
                    return jax.lax.fori_loop(
                        0, n, lambda _, c: self._coupled_step_fn(c), carry
                    )
            self._coupled_roll_jit = jax.jit(_roll, static_argnums=1)
        return self._coupled_roll_jit((state, rigid), num_steps)

    def run_coupled(self, state: SimState, rigid, num_steps: int, **kw):
        """Long sharded coupled runs (adaptive recapacity over the
        (SimState, RigidState) carry — see SolverBase._run_adaptive)."""
        if self.spec is None:
            state = self.bind(state)
        return self._run_adaptive(
            (state, rigid), num_steps,
            lambda c, k: self.rollout_coupled(c[0], c[1], k),
            lambda c: c[0], lambda c, s: (s, c[1]), **kw
        )

    # ------------------------------------------------------------------
    def _step_fn(self, state: SimState) -> SimState:
        scfg = self.sweep_cfg
        if scfg.impl == "pallas":
            state, cache = self._seg_build(state)
            return self._seg_apply(state, cache)
        return self._step_fn_windowed(state)

    def _step_fn_windowed(self, state: SimState) -> SimState:
        """Blocked jnp sweep step: sort + structure + sweeps rebuilt every
        substep."""
        spec, params, scfg = self.spec, self.params, self.sweep_cfg
        ax = self.axis
        hn = self.halo
        shard_rows = self._shard_rows
        hops = self._hops()
        axis_spec = P(ax)

        state, sorted_ids = self._resort(state)

        dens_k = F.density_kernel(params, spec)
        force_k = F.force_kernel(params, spec)

        def sweep_shard(mode, kern, ids_l, x, v, density, pressure, mass, volume, material):
            """One halo-extended blocked sweep on this shard.

            Returns (result, halo_flag, window_need): the scalar diagnostics
            are pmax'd over shards — halo_flag trips when some required cell
            range reaches past the ids the halo-extended array actually
            covers (fluid migrated across slabs since bind measured the
            reach), window_need is the per-dispatch window requirement
            (same contract as the single-chip path)."""
            f_local = dict(
                x=x, v=v, density=density, pressure=pressure,
                mass=mass, volume=volume, material=material,
            )
            ext, off = self._extend(
                {**f_local, "ids": ids_l}, hn, hops, shard_rows
            )
            f_ext = {k: ext[k] for k in _FIELD_KEYS}
            ids_e = ext["ids"]
            coords_l = gridops.cell_coords(x, spec)
            ranges = gridops.cell_target_ranges(coords_l, spec)
            halo_flag = self._cover_flag(ids_l, ids_e, ranges, hops)

            wstarts, wends = gridops.block_window_bounds(
                ids_e, coords_l, spec, scfg.block_size, ids_i=ids_l
            )
            need = jnp.max(jnp.maximum(wends - wstarts, 0))
            nd = NeighborData(
                cell_ranges=ranges,
                wstarts=wstarts,
                sorted_ids=ids_e,
            )
            acc = neighbor_sweep_blocked(
                nd.cell_ranges, nd.wstarts, nd.sorted_ids, f_ext["x"],
                kern[0](f_local), kern[1](f_ext), kern[2], kern[3](f_local),
                spec, params.support_length, scfg.block_size,
                scfg.window_cap, x_i=x, i_offset=off,
            )
            need = need.astype(jnp.int32)
            if self.n_shards > 1:
                need = jax.lax.pmax(need, ax)
            if mode == "density":
                fluid = material == 1
                return (jnp.where(fluid, acc["rho"], density),
                        halo_flag, need)
            fluid = (material == 1)[:, None]
            return (jnp.where(fluid, acc["dv"], 0.0), halo_flag, need)

        scalar_spec = P()  # pmax'd over shards -> replicated

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(axis_spec,) + (axis_spec,) * len(_FIELD_KEYS),
            out_specs=(axis_spec, scalar_spec, scalar_spec),
            check_vma=False,
        )
        def density_shard(ids_l, *fields):
            return sweep_shard("density", dens_k, ids_l, *fields)

        f = F.state_fields(state)
        density, hflag_d, need_d = density_shard(
            sorted_ids, *[f[k] for k in _FIELD_KEYS]
        )
        rho, pressure = tait_pressure(
            density, params.density0, params.stiffness, params.exponent
        )
        state = dataclasses.replace(state, density=rho, pressure=pressure)

        @partial(
            jax.shard_map,
            mesh=self.mesh,
            in_specs=(axis_spec,) + (axis_spec,) * len(_FIELD_KEYS),
            out_specs=(axis_spec, scalar_spec, scalar_spec),
            check_vma=False,
        )
        def force_shard(ids_l, *fields):
            return sweep_shard("force", force_k, ids_l, *fields)

        f = F.state_fields(state)
        d_velocity, hflag_f, need_f = force_shard(
            sorted_ids, *[f[k] for k in _FIELD_KEYS]
        )

        # fold the per-dispatch diagnostics (same contract as single-chip)
        state = self._track_occ(state, jnp.maximum(need_d, need_f))
        state = dataclasses.replace(
            state,
            occ_halo=jnp.maximum(
                jnp.asarray(state.occ_halo, jnp.int32),
                jnp.maximum(hflag_d, hflag_f).astype(jnp.int32),
            ),
        )

        # ---- local phases -------------------------------------------------
        state = F.advect(state, d_velocity, params)
        return F.enforce_domain_boundary(state, params)

    # ------------------------------------------------------------------
    def regrow_halo(self, new_halo: int | None = None) -> None:
        """Deepen the halo (default: double) and drop compiled artifacts.
        Called by :meth:`run` when ``occ_halo`` trips — fluid migrated
        across slabs until some shard's stencil reach exceeded the depth
        measured at bind (dam-break pile-up concentrates particles into few
        x-slabs, so the reach GROWS over a run).  A no-op when already at
        the cap (recompiling then would make no progress)."""
        h = int(new_halo if new_halo is not None else self.halo * 2)
        h = max(128, -(-h // 128) * 128)
        b = self.sweep_cfg.block_size if self.sweep_cfg is not None else 128
        h = -(-h // b) * b
        if self.n_shards > 1:
            h = min(h, (self.n_shards - 1) * self._shard_rows)
        if h == self.halo:
            return
        self.halo = h
        for name in [k for k in vars(self) if k.endswith("_jit")]:
            setattr(self, name, None)

    def regrow_resort_edge(self, new_edge: int | None = None) -> None:
        """Deepen the exchange resort's edge depth (default: double) and drop
        compiled artifacts.  Called by :meth:`run` when ``occ_resort`` shows
        the seam guard tripping on most rebuilds — the flow's inter-rebuild
        rank shift beat the edge depth, so every resort is paying the stock
        distributed sort's all_gather on top of the wasted exchange."""
        if self.resort != "exchange" or self.n_shards <= 1:
            return
        e = int(new_edge if new_edge is not None
                else (self.resort_edge or 128) * 2)
        e = max(128, -(-e // 128) * 128)
        e = min(e, self._shard_rows)
        if e == self.resort_edge:
            return
        self.resort_edge = e
        for name in [k for k in vars(self) if k.endswith("_jit")]:
            setattr(self, name, None)

    def run(
        self,
        state: SimState,
        num_steps: int,
        check_every: int = 400,
        grow: float = 1.5,
        verbose: bool = False,
        max_dispatch: int = 400,
        warn_frac: float = 0.9,
    ) -> SimState:
        """Sharded rollout with adaptive halo + window recapacity: after
        every dispatch the pmax'd ``occ_halo`` flag and window requirement
        are checked (two scalar fetches), mirroring the single-chip
        overflow contract (SolverBase.run)."""
        done = 0
        chunk = max(1, min(check_every, max_dispatch))
        while done < num_steps:
            k = min(chunk, num_steps - done)
            state = self.rollout(state, k)
            done += k
            if int(jax.device_get(state.occ_halo)):
                old = self.halo
                self.regrow_halo()
                if verbose:
                    print(f"[tisph] shard halo reach exceeded depth {old}; "
                          f"deepened to {self.halo} (recompile)")
            occ = int(jax.device_get(state.occ_window))
            cap = self._occ_cap()
            if cap and occ > warn_frac * cap:
                self.regrow(int(max(occ, cap) * grow))
                if verbose:
                    print(f"[tisph] window occupancy {occ} "
                          f"{'exceeded' if occ > cap else 'approaching'} cap "
                          f"{cap}; re-capacitated to "
                          f"{self.sweep_cfg.window_cap} (recompile)")
            cfg_s = self.sweep_cfg
            if cfg_s is not None and cfg_s.impl == "pallas":
                pad_occ = int(jax.device_get(state.occ_rowpad))
                pad_cap = int(cfg_s.pad_capacity)
                if pad_cap and pad_occ > warn_frac * pad_cap:
                    self.regrow(new_pad=int(max(pad_occ, pad_cap) * grow))
                    if verbose:
                        print(f"[tisph] shard seg block occupancy {pad_occ} "
                              f"over cap {pad_cap}; re-capacitated to "
                              f"{self.sweep_cfg.pad_capacity} (recompile)")
            if self.resort == "exchange" and self.n_shards > 1:
                trips = int(jax.device_get(state.occ_resort))
                rr = cfg_s.resort_every if (
                    cfg_s is not None and cfg_s.impl == "pallas"
                ) else 1
                rebuilds = max(1, k // max(1, rr))
                # occasional trips (first rebuild, emitter bursts) are the
                # fallback doing its job; trips on most rebuilds mean the
                # edge depth lost to the flow — deepen it
                if trips > rebuilds // 2:
                    old = self.resort_edge
                    self.regrow_resort_edge()
                    if self.resort_edge == old and old >= self._shard_rows:
                        # edge saturated at shard_rows and the guard still
                        # trips on most rebuilds: every resort pays the
                        # full exchange PLUS the stock-sort fallback.
                        # Escape to the stock sort instead of paying both
                        # forever (ADVICE r4 #2).
                        self.resort = "global"
                        for nm in [k for k in vars(self)
                                   if k.endswith("_jit")]:
                            setattr(self, nm, None)
                        if verbose:
                            print(f"[tisph] exchange-resort edge saturated "
                                  f"at shard_rows={old} with persistent "
                                  f"seam-guard trips ({trips}/{rebuilds}); "
                                  f"switching resort to 'global'")
                    elif verbose and self.resort_edge != old:
                        print(f"[tisph] exchange-resort seam guard tripped "
                              f"{trips}/{rebuilds} rebuilds at edge {old}; "
                              f"deepened to {self.resort_edge} (recompile)")
            state = dataclasses.replace(
                state,
                occ_window=jnp.zeros((), jnp.int32),
                occ_halo=jnp.zeros((), jnp.int32),
                occ_rowpad=jnp.zeros((), jnp.int32),
                occ_resort=jnp.zeros((), jnp.int32),
            )
        return state

    def metrics(self, state: SimState) -> dict[str, jax.Array]:
        """Sharded metrics: the physics diagnostics plus the occupancy /
        capacity pairs the adaptive run() loop steers by (VERDICT r2 #8 —
        the running per-dispatch maxima are surfaced instead of a live
        re-measurement, which would cost a full distributed sort+plan
        pass)."""
        params = self.params
        cfg = self.sweep_cfg

        if getattr(self, "_metrics_jit", None) is None:
            @jax.jit
            def _metrics(st: SimState):
                fluid = st.fluid_mask
                speed = jnp.sqrt(jnp.sum(st.v * st.v, axis=-1))
                vmax = jnp.max(jnp.where(fluid, speed, 0.0))
                rho_err = jnp.where(
                    fluid, jnp.abs(st.density - params.density0) / params.density0, 0.0
                )
                nf = jnp.maximum(jnp.sum(fluid), 1)
                return {
                    "max_velocity": vmax,
                    "cfl": vmax * params.dt / params.support_length,
                    "avg_density_error": jnp.sum(rho_err) / nf,
                    "max_density_error": jnp.max(rho_err),
                    "num_active": st.num_active,
                    "nan_count": jnp.sum(~jnp.isfinite(st.x)) + jnp.sum(~jnp.isfinite(st.v)),
                    "max_run_length": jnp.asarray(st.occ_window, jnp.int32),
                    "occ_halo": jnp.asarray(st.occ_halo, jnp.int32),
                    "seg_pad_occ": jnp.asarray(st.occ_rowpad, jnp.int32),
                    "resort_fallbacks": jnp.asarray(st.occ_resort, jnp.int32),
                }

            self._metrics_jit = _metrics
        out = dict(self._metrics_jit(state))
        out["run_cap"] = jnp.asarray(self._occ_cap(), jnp.int32)
        out["halo_depth"] = jnp.asarray(self.halo or 0, jnp.int32)
        out["seg_pad_cap"] = jnp.asarray(
            cfg.pad_capacity if cfg is not None else 0, jnp.int32
        )
        out["resort_edge"] = jnp.asarray(self.resort_edge or 0, jnp.int32)
        return out
