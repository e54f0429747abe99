"""Solver base: step orchestration shared by the WCSPH variants.

Reference counterpart: SPHBase / SPHBaseV2 ``step()`` orchestration
(sph_base.py:168-172, sph_basev2.py:210-214):

    resort -> boundary volumes -> substep(density, forces, advect) -> clamp

Here the whole step is ONE jitted pure function ``state' = step(state)``;
``rollout`` wraps N steps in a ``lax.fori_loop`` so the host dispatches a
frame (or a whole benchmark) at a time instead of one Taichi kernel launch
per phase (the reference does ~8 launches + a device sync per substep,
SURVEY.md §3.1).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from tisph.config import SceneConfig, SolverParams
from tisph.models.state import SimState
from tisph.ops import grid as gridops
from tisph.ops.neighbors import SweepConfig, platform_sweep_impl


class SolverBase:
    """Holds static configuration (SolverParams + GridSpec) and the jitted
    step.  All simulation state lives in the SimState pytree."""

    def __init__(
        self,
        scene: SceneConfig,
        compat: str = "reference",
        run_cap: int | None = None,
        params: SolverParams | None = None,
        sweep_cfg: SweepConfig | None = None,
        boundary_mode: str = "static",
    ):
        """``sweep_cfg`` selects the neighbor-sweep implementation; None =
        resolve automatically at :meth:`bind` from the default backend
        (ops.neighbors.platform_sweep_impl), with measured caps.

        ``boundary_mode``: 'static' computes Akinci boundary volumes once at
        bind (boundary particles never move, so the per-step recompute the
        reference does at sph_basev2.py:212 is redundant); 'per_step'
        reproduces the reference behavior exactly (needed once dynamic
        rigid bodies exist)."""
        if boundary_mode not in ("static", "per_step"):
            raise ValueError(f"unknown boundary_mode {boundary_mode!r}")
        self.scene = scene
        self.params = params if params is not None else SolverParams.from_scene(scene, compat)
        self._run_cap = run_cap
        self.spec: gridops.GridSpec | None = None
        if run_cap is not None:
            self.spec = self._make_spec(run_cap)
        self.sweep_cfg = sweep_cfg
        self.boundary_mode = boundary_mode
        self._step_jit: Callable[[SimState], SimState] | None = None
        self._rollout_jit = None
        self._emit_roll_jit = None
        self._metrics_jit = None

    def _make_spec(self, run_cap: int) -> gridops.GridSpec:
        return gridops.make_grid_spec(
            dim=self.scene.dim,
            domain_start=self.scene.domain_start,
            domain_end=self.scene.domain_end,
            support_length=self.scene.support_length,
            run_cap=run_cap,
        )

    def bind(self, state: SimState) -> SimState:
        """Resolve static capacities from the actual initial state (overflow
        accounting replaces the reference's fixed caps of 100/1000 neighbors,
        partice_system.py:25-26 / partice_systemv3.py:26-27) and precompute
        static boundary volumes.  Returns the (possibly updated) state."""
        if self.spec is None or self.sweep_cfg is None:
            probe = self.spec if self.spec is not None else self._make_spec(run_cap=8)
            block = self.sweep_cfg.block_size if self.sweep_cfg is not None else 128
            # one device pass; only scalars cross the host boundary
            run_len, window, _ = gridops.measure_caps_device(state, probe, block)
        if self.spec is None:
            cap = max(8, -(-int(run_len * 1.5) // 8) * 8)
            self.spec = self._make_spec(cap)
        if self.sweep_cfg is None:
            wcap = max(128, -(-int(window * 1.5) // 128) * 128)
            self.sweep_cfg = SweepConfig(
                impl=platform_sweep_impl(jax.default_backend()),
                block_size=block, window_cap=wcap,
            )
        if self.sweep_cfg.impl == "pallas":
            if self.spec.num_cells >= 2**24:
                raise ValueError(
                    "pallas sweep packs cell ids as f32; num_cells "
                    f"{self.spec.num_cells} >= 2**24 would lose precision"
                )
            self.sweep_cfg = self._bind_seg(state, self.sweep_cfg)
        if self.boundary_mode == "static":
            state = self._precompute_boundary_volumes(state)
        # static gate for the boundary-aware seg block skips: scenes with
        # no boundary particles compile the plain (non-skippable) sweep
        # kernels; the particle material set is fixed for the whole run
        # (emitters activate FLUID slots only), so one scalar fetch here
        # decides the kernel variant for every subsequent compile
        self._has_boundary = bool(
            jax.device_get(jnp.any(state.material == 0))
        )
        return state

    def _bind_seg(self, state: SimState, cfg) -> SweepConfig:
        """Resolve the seg-layout static capacities by MEASURING the
        initial state (one device seg pass): the logical-block capacity is
        the measured block need with modest slack — every padded block is
        launched whether used or not, so loose static headroom is a
        permanent per-step cost; run()'s adaptive grow/shrink handles
        drift at runtime — and the window cap is at least the measured
        longest window with 1.5x slack (the kernels loop over the actual
        window lengths, so headroom in the cap costs nothing)."""
        import dataclasses as _dc

        from tisph.ops.pallas import sweeps as psweeps

        block = cfg.block_size
        user_pad = cfg.pad_capacity > 0
        if not user_pad:
            cfg = _dc.replace(
                cfg,
                pad_capacity=gridops.suggest_block_capacity(state, self.spec, block),
            )
        spec = self.spec
        block_cap = cfg.pad_capacity // block
        wcap0 = cfg.window_cap

        @jax.jit
        def _measure(st: SimState):
            _, ids, _ = gridops.sort_state_by_cell(st, spec)
            plan = gridops.seg_plan(ids, spec, block, block_cap)
            _, need = psweeps.seg_block_meta(plan, ids, spec, block, wcap0)
            return need, plan.need_blocks

        need, nblocks = (int(v) for v in jax.device_get(_measure(state)))
        if not user_pad:
            cfg = _dc.replace(
                cfg, pad_capacity=(int(nblocks * 1.25) + 256) * block
            )
        elif nblocks > block_cap:
            cfg = _dc.replace(cfg, pad_capacity=(nblocks + 2048) * block)
        wcap = int(-(-int(need * 1.5) // 128) * 128)
        return _dc.replace(cfg, window_cap=max(wcap, cfg.window_cap, 128))

    def _precompute_boundary_volumes(self, state: SimState) -> SimState:
        """One-time Akinci boundary volume pass (see boundary_mode)."""
        import dataclasses

        from tisph.ops import forces as F

        if not bool(jax.device_get(jnp.any(state.boundary_mask))):
            return state  # no boundary particles at all

        spec, params = self.spec, self.params
        # one-time pass: always use the jnp blocked sweep (the pallas impl
        # shares its window parameters but has its own data layout)
        import dataclasses as _dc

        scfg = self.sweep_cfg
        if scfg.impl == "pallas":
            scfg = _dc.replace(scfg, impl="blocked")

        @jax.jit
        def _compute(st: SimState) -> SimState:
            st_sorted, sorted_ids, perm = gridops.sort_state_by_cell(st, spec)
            nd = gridops.build_neighbor_data(st_sorted, sorted_ids, spec, scfg)
            vol = F.compute_boundary_volumes(st_sorted, nd, spec, params, scfg)
            # Scatter volumes back into the caller's (unsorted) order so the
            # returned state is positionally unchanged.
            inv = jnp.zeros_like(perm).at[perm].set(
                jnp.arange(perm.shape[0], dtype=perm.dtype)
            )
            return dataclasses.replace(st, volume=jnp.take(vol, inv, axis=0))

        return _compute(state)

    # -- to be provided by concrete solvers ------------------------------
    def _step_fn(self, state: SimState) -> SimState:
        raise NotImplementedError

    @staticmethod
    def _track_occ(state: SimState, need) -> SimState:
        """Fold this step's required window length into the running
        ``occ_window`` diagnostic (see SimState.occ_window)."""
        import dataclasses as _dc

        if need is None:
            return state
        return _dc.replace(
            state,
            occ_window=jnp.maximum(
                jnp.asarray(state.occ_window, jnp.int32), need.astype(jnp.int32)
            ),
        )

    def _occ_cap(self) -> int:
        """The static capacity ``occ_window`` is compared against."""
        if self.sweep_cfg is not None and self.sweep_cfg.impl == "gather":
            return int(self.spec.run_cap)
        return int(self.sweep_cfg.window_cap) if self.sweep_cfg else 0

    # -- public API ------------------------------------------------------
    def step(self, state: SimState) -> SimState:
        """One solver step (resort + physics + boundary), jit-compiled."""
        if self.spec is None:
            state = self.bind(state)
        if self._step_jit is None:
            self._step_jit = jax.jit(self._step_fn)
        return self._step_jit(state)

    def _amortize_R(self) -> int:
        """resort_every if the amortized seg schedule applies, else 1.
        One definition for ALL rollouts (rollout / rollout_emit /
        WCSPHRigid.rollout_coupled) so the gate cannot drift."""
        cfg = self.sweep_cfg
        R = int(getattr(cfg, "resort_every", 1) or 1) if cfg is not None else 1
        if (
            R > 1 and cfg is not None and cfg.impl == "pallas"
            and hasattr(self, "_seg_build")
        ):
            return R
        return 1

    def _amortized_groups(self, R: int, n: int, carry, get_state, set_state,
                          apply_body):
        """Shared R-group schedule: fori over ceil(n/R) groups — rebuild
        the seg structure once per group from the carry's SimState, then
        run k = min(R, n - i*R) substeps of ``apply_body(carry, cache)``
        against the cached structure (traced tail bound).  The single
        definition of the group/tail arithmetic for every amortized
        rollout variant."""
        def outer(i, c):
            s, cache = self._seg_build(get_state(c))
            k = jnp.minimum(R, n - i * R)
            return jax.lax.fori_loop(
                0, k, lambda _, c2: apply_body(c2, cache), set_state(c, s)
            )
        return jax.lax.fori_loop(0, -(-n // R), outer, carry)

    def rollout(self, state: SimState, num_steps: int) -> SimState:
        """Run ``num_steps`` steps inside one jitted fori_loop.

        With ``sweep_cfg.resort_every = R > 1`` on the pallas sweeps,
        the sort/plan/meta rebuild runs every R substeps and the cached
        structure is reused in between (see WCSPH._seg_apply for why that
        is safe); the reference resorts every substep."""
        if self.spec is None:
            state = self.bind(state)
        R = self._amortize_R()
        if self._rollout_jit is None:
            if R > 1 and hasattr(self, "_seg_apply_pack"):
                # pack-carry R-groups: the (16, n) pack is the substep
                # carry; SimState <-> pack syncs happen once per GROUP
                # (pack at rebuild, unpack at group end) instead of per
                # substep — the per-substep transposes were a measured
                # residue (VERDICT r3 weak #2)
                from tisph.ops.pallas import sweeps as psweeps

                params = self.params

                def _roll(s: SimState, n: int) -> SimState:
                    def outer(i, st):
                        st, cache = self._seg_build(st)
                        pack = psweeps.pack_state(
                            st.x, st.v, st.density, st.pressure, st.mass,
                            st.volume, st.material, cache[2], params,
                        )
                        k = jnp.minimum(R, n - i * R)
                        pack = jax.lax.fori_loop(
                            0, k,
                            lambda _, p: self._seg_apply_pack(p, cache),
                            pack,
                        )
                        return self._seg_unpack(st, pack)

                    return jax.lax.fori_loop(0, -(-n // R), outer, s)
            elif R > 1:
                def _roll(s: SimState, n: int) -> SimState:
                    return self._amortized_groups(
                        R, n, s, lambda c: c, lambda c, s2: s2,
                        lambda c2, cache: self._seg_apply(c2, cache),
                    )
            else:
                def _roll(s: SimState, n: int) -> SimState:
                    return jax.lax.fori_loop(
                        0, n, lambda _, st: self._step_fn(st), s
                    )
            self._rollout_jit = jax.jit(_roll, static_argnums=1)
        return self._rollout_jit(state, num_steps)

    def _maybe_emit(self, state: SimState, es, volume0: float):
        """One emitter activation attempt (pure / jittable).  The default
        is the global-layout emission (geometry/emitter.py: tail pool =
        the inactive slots after the global cell sort); solvers whose
        state layout has a different pool structure override this
        (ShardedWCSPH2D: per-shard tails)."""
        from tisph.geometry.emitter import maybe_emit

        return maybe_emit(state, es, volume0)

    def rollout_emit(self, state: SimState, emitters, num_steps: int):
        """``num_steps`` fused (emit -> step) iterations in ONE dispatch.

        The per-step host loop (one dispatch per solver step) pays the
        host dispatch latency every step; fusing the emitter update into
        the rollout's fori_loop removes it.

        With ``resort_every = R > 1`` on the pallas sweeps the emission is
        fused into the R-group rebuild loop (VERDICT r2 #7): ``maybe_emit``
        still runs every substep (its interval counters keep the emission
        cadence exact), but particles activated mid-group only join the
        neighbor structure at the next group rebuild — up to R-1 substeps
        of ballistic flight (they advect with their emission velocity,
        exchange no forces).  At dt ~ 2e-4 and R <= 3 that is far below
        the resort-staleness divergence already accepted for R (see
        WCSPH._seg_apply); emitter placement keeps new particles > h away
        from the jet front, so no overlap pair is ever missed.
        Returns (state, emitters)."""
        if self.spec is None:
            state = self.bind(state)
        R = self._amortize_R()
        if self._emit_roll_jit is None:
            vol0 = self.scene.particle_volume0

            def emit_all(s, ems):
                ems = list(ems)
                for i, es in enumerate(ems):
                    s, ems[i] = self._maybe_emit(s, es, vol0)
                return s, tuple(ems)

            if R > 1:
                def _roll(carry, n: int):
                    def body(c2, cache):
                        s2, ems2 = emit_all(*c2)
                        return (self._seg_apply(s2, cache), ems2)

                    return self._amortized_groups(
                        R, n, carry,
                        lambda c: c[0], lambda c, s: (s, c[1]), body,
                    )
            else:
                def _roll(carry, n: int):
                    def body(_, c):
                        s, ems = c
                        s, ems = emit_all(s, ems)
                        return (self._step_fn(s), ems)

                    return jax.lax.fori_loop(0, n, body, carry)

            self._emit_roll_jit = jax.jit(_roll, static_argnums=1)
        state, ems = self._emit_roll_jit((state, tuple(emitters)), num_steps)
        return state, list(ems)

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
        """See _run_adaptive — this is the plain-rollout instantiation."""
        return self._run_adaptive(
            state, num_steps, lambda c, k: self.rollout(c, k),
            lambda c: c, lambda c, s: s,
            check_every=check_every, grow=grow, verbose=verbose,
            max_dispatch=max_dispatch, warn_frac=warn_frac,
        )

    def _run_adaptive(
        self,
        carry,
        num_steps: int,
        roll,
        get_state,
        set_state,
        check_every: int = 400,
        grow: float = 1.5,
        verbose: bool = False,
        max_dispatch: int = 400,
        warn_frac: float = 0.9,
    ):
        """Rollout with overflow-safe adaptive recapacity.

        The candidate-window capacity is measured from the INITIAL
        configuration; as fluid compacts (dam-break pile-up) per-block
        windows can exceed it, silently dropping the farthest candidates
        (the reference's analog corrupts memory instead,
        partice_systemv3.py:214-217).  Every step folds its required window
        length into ``state.occ_window`` (one device scalar), so overflow is
        detected after EVERY dispatch — not merely every ``check_every``
        steps — and the re-capacity triggers EARLY, at ``warn_frac`` of the
        cap, usually before any candidate is actually dropped.

        ``check_every`` now only bounds how many steps run between host
        checks (and hence the worst-case number of steps a late overflow
        could degrade); each check costs one scalar fetch.

        Dispatch duration is also bounded ADAPTIVELY: chunks are timed on
        the host and the chunk size halves whenever a warm dispatch
        exceeds ~25 s, so a slow-step regime (e.g. a transient capacity
        blow-up mid collapse) still returns to the host for its overflow
        checks every few seconds.  Whether that adaptivity pays on a GPU
        is unmeasured (ROADMAP D5).
        """
        import dataclasses as _dc
        import time as _time

        done = 0
        budget_s = 25.0
        low_checks = 0      # consecutive low-occupancy checks (cap shrink)
        pad_low_checks = 0  # same, for the seg block pad
        warm: set[int] = set()  # chunk sizes whose rollout is compiled
        cap_chunk = max(1, min(check_every, max_dispatch))
        while done < num_steps:
            k = min(cap_chunk, num_steps - done)
            t0 = _time.perf_counter()
            carry = roll(carry, k)
            state = get_state(carry)
            jax.block_until_ready(state.x)
            wall = _time.perf_counter() - t0
            cold = k not in warm  # first call per shape pays the compile
            warm.add(k)
            done += k
            # adapt only on WARM walls — a cold wall is compile-dominated
            # and halving on it just mints another cold shape (measured
            # death spiral in the round-2 soak)
            if not cold and wall > budget_s and cap_chunk > 25:
                cap_chunk = max(25, cap_chunk // 2)
                if verbose:
                    print(f"[tisph] {k}-step dispatch took {wall:.1f}s; "
                          f"chunk size lowered to {cap_chunk}")
            elif (
                not cold and wall < budget_s / 4
                and cap_chunk < min(check_every, max_dispatch)
            ):
                cap_chunk = min(cap_chunk * 2, check_every, max_dispatch)
            caps_before = (self.sweep_cfg, self.spec)
            occ = int(jax.device_get(state.occ_window))
            cap = self._occ_cap()
            if occ > warn_frac * cap:
                dropped = occ > cap
                self.regrow(int(max(occ, cap) * grow))
                low_checks = 0
                if verbose:
                    print(
                        f"[tisph] window occupancy {occ} "
                        f"{'exceeded' if dropped else 'approaching'} cap {cap}; "
                        f"re-capacitated to "
                        f"{self._occ_cap()}"
                        + (
                            f" (up to {k} steps may have dropped far candidates)"
                            if dropped
                            else ""
                        )
                    )
            elif (occ > 0 and occ < 0.4 * cap and int(occ * grow) + 384 < cap
                  and self.sweep_cfg.impl != "pallas"):
                # transient spikes (splash compression) force the cap up and
                # the blocked sweep's window cost (it always processes
                # window_cap lanes) would stay pinned forever; shrink back
                # after sustained low occupancy (hysteresis: 3 checks).
                # The pallas kernels loop over the actual lengths, so their
                # cap is free and never shrunk (that would only recompile).
                # The +384 headroom guarantees the 128-lane quantisation
                # inside regrow() lands strictly BELOW the current cap
                # (otherwise a "shrink" could round back up — or past — it).
                low_checks += 1
                if low_checks >= 3:
                    self.regrow(int(occ * grow))
                    low_checks = 0
                    if verbose:
                        print(f"[tisph] window occupancy {occ} well under "
                              f"cap {cap}; shrunk to {self._occ_cap()}")
            else:
                low_checks = 0
            cfg = self.sweep_cfg
            if cfg is not None and cfg.impl == "pallas":
                pad_occ = int(jax.device_get(state.occ_rowpad))
                pad_cap = int(cfg.pad_capacity)
                if pad_occ > warn_frac * pad_cap:
                    self.regrow(new_pad=int(max(pad_occ, pad_cap) * grow))
                    pad_low_checks = 0
                    if verbose:
                        print(
                            f"[tisph] seg block occupancy {pad_occ} "
                            f"{'exceeded' if pad_occ > pad_cap else 'approaching'} "
                            f"cap {pad_cap} slots; re-capacitated to "
                            f"{self.sweep_cfg.pad_capacity}"
                        )
                elif pad_occ > 0 and pad_occ < 0.5 * pad_cap:
                    # every padded block is launched (grid covers
                    # block_cap, not need_blocks) — shrink when spray
                    # settles so unused blocks stop costing programs; same
                    # hysteresis as the window shrink (a single low check
                    # mid-splash would thrash grow/shrink recompiles)
                    pad_low_checks += 1
                    if pad_low_checks >= 3:
                        self.regrow(new_pad=int(pad_occ * grow))
                        pad_low_checks = 0
                        if verbose:
                            print(f"[tisph] seg block occupancy {pad_occ} "
                                  f"well under cap {pad_cap}; shrunk to "
                                  f"{self.sweep_cfg.pad_capacity}")
                else:
                    pad_low_checks = 0
            if (self.sweep_cfg, self.spec) != caps_before:
                warm.clear()  # regrow dropped the compiled rollouts
            carry = set_state(carry, _dc.replace(
                state,
                occ_window=jnp.zeros((), jnp.int32),
                occ_rowpad=jnp.zeros((), jnp.int32),
            ))
        return carry

    def regrow(self, new_window: int | None = None, new_pad: int | None = None) -> None:
        """Re-capacitate the sweep/run window (``new_window``) and/or the
        seg block pad (``new_pad``) and drop ALL compiled artifacts
        (including subclass-cached jits like WCSPHRigid's coupled step —
        anything stored in an attribute ending in ``_jit``).

        A NO-OP when quantisation lands on the current capacities: lane
        rounding can map a requested shrink back onto the same cap, and
        dropping the jits then would recompile for nothing — run()'s
        hysteresis shrink relies on this guard."""
        import dataclasses as _dc

        before = (self.sweep_cfg, self.spec)
        cfg = self.sweep_cfg
        if new_window is not None:
            if cfg is not None and cfg.impl == "gather":
                # the gather sweep reads spec.run_cap, not window_cap
                cap = max(8, int(-(-new_window // 8) * 8))
                self.spec = _dc.replace(self.spec, run_cap=cap)
            else:
                wcap = int(-(-new_window // 128) * 128)
                self.sweep_cfg = cfg = _dc.replace(cfg, window_cap=wcap)
        if new_pad is not None and cfg is not None:
            pcap = int(-(-new_pad // cfg.block_size) * cfg.block_size)
            self.sweep_cfg = _dc.replace(cfg, pad_capacity=pcap)
        if (self.sweep_cfg, self.spec) == before:
            return
        for name in [k for k in vars(self) if k.endswith("_jit")]:
            setattr(self, name, None)

    def metrics(self, state: SimState) -> dict[str, jax.Array]:
        """Structured step metrics (SURVEY.md §5.5: the reference has only
        prints; we expose max velocity, density error, CFL, run overflow)."""
        if self.spec is None:
            state = self.bind(state)
        if getattr(self, "_metrics_jit", None) is not None:
            return self._metrics_jit(state)
        spec, params = self.spec, self.params

        @jax.jit
        def _metrics(st: SimState):
            fluid = st.fluid_mask
            speed = jnp.sqrt(jnp.sum(st.v * st.v, axis=-1))
            vmax = jnp.max(jnp.where(fluid, speed, 0.0))
            rho_err = jnp.where(
                fluid, jnp.abs(st.density - params.density0) / params.density0, 0.0
            )
            nf = jnp.maximum(jnp.sum(fluid), 1)
            sorted_state, sorted_ids, _ = gridops.sort_state_by_cell(st, spec)
            bounds = gridops.csr_bounds(sorted_ids, spec)
            coords = gridops.cell_coords(sorted_state.x, spec)
            runs = gridops.stencil_runs(coords, bounds, spec)
            # inert runs for inactive tail rows (their coords are parked
            # positions; they must not inflate the window measurement)
            inact = (sorted_ids >= spec.num_cells)[:, None, None]
            runs = jnp.where(inact, jnp.asarray(st.capacity, runs.dtype), runs)
            cfg = self.sweep_cfg
            if cfg is not None and cfg.impl == "gather":
                occupancy = gridops.max_run_length(runs)
                occupancy_cap = jnp.asarray(spec.run_cap)
            elif cfg is not None and cfg.impl == "pallas":
                # seg windows are single-column; measure the layout's own
                # requirement (same quantity _track_occ folds per step)
                from tisph.ops.pallas import sweeps as psweeps

                plan = gridops.seg_plan(
                    sorted_ids, spec, cfg.block_size,
                    cfg.pad_capacity // cfg.block_size,
                )
                _, occupancy = psweeps.seg_block_meta(
                    plan, sorted_ids, spec, cfg.block_size, cfg.window_cap
                )
                occupancy_cap = jnp.asarray(cfg.window_cap)
            else:
                block = cfg.block_size if cfg is not None else 128
                occupancy = gridops.max_window_length(runs, block)
                occupancy_cap = jnp.asarray(cfg.window_cap if cfg is not None else 0)
            return {
                "max_velocity": vmax,
                "cfl": vmax * params.dt / params.support_length,
                "avg_density_error": jnp.sum(rho_err) / nf,
                "max_density_error": jnp.max(rho_err),
                "max_run_length": occupancy,
                "run_cap": occupancy_cap,
                "num_active": st.num_active,
                "nan_count": jnp.sum(~jnp.isfinite(st.x)) + jnp.sum(~jnp.isfinite(st.v)),
            }

        self._metrics_jit = _metrics
        return _metrics(state)
