"""Count the collective bytes of one sharded WCSPH step (the 1e9 bridge).

Lowers the ShardedWCSPH step (and an amortized R-group) for an N-device
mesh, compiles it on the virtual CPU mesh, and walks the optimized HLO for
communication ops (collective-permute, all-to-all, all-gather, all-reduce,
reduce-scatter), summing each op's output bytes.  The SPMD partitioner
inserts the SAME collective structure on the virtual mesh as on a mesh of
cards, so the byte counts are hardware-faithful even though the timing is
not — this is the measured input to the multi-chip scaling model in
docs/design.md ("The bridge to 1e9").

Usage:
    python tools/collective_bytes.py [--devices 8] [--radius 0.02]
        [--resort 2]
"""

from __future__ import annotations

import argparse
import json
import os
import re

import numpy as np

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4,
    "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
}

# one HLO op result can be a tuple: capture every dtype[shape] group on
# the lhs of the op
_SHAPE_RE = re.compile(r"(f64|f32|bf16|f16|s64|u64|s32|u32|s16|u16|s8|u8|pred)"
                       r"\[([0-9,]*)\]")
_COLLECTIVES = ("collective-permute", "all-to-all", "all-gather",
                "all-reduce", "reduce-scatter")


def _shape_bytes(text: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(text):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


_COMP_START_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(")
_COND_REF_RES = (
    re.compile(r"true_computation=%?([\w.\-]+)"),
    re.compile(r"false_computation=%?([\w.\-]+)"),
)
_COND_BRANCHES_RE = re.compile(r"branch_computations=\{([^}]*)\}")
_UNCOND_REF_RES = (
    re.compile(r"to_apply=%?([\w.\-]+)"),
    re.compile(r"body=%?([\w.\-]+)"),
    re.compile(r"condition=%?([\w.\-]+)"),
    re.compile(r"calls=%?([\w.\-]+)"),
)
# a collective can be a computation root ("ROOT %x = ... all-gather ...")
_COLLECTIVE_RE = re.compile(
    r"(?:ROOT )?%?[\w.\-]+ = (.+?) (collective-permute|all-to-all|"
    r"all-gather|all-reduce|reduce-scatter)"
)


def _parse_computations(hlo_text: str):
    """HLO module text -> (entry name, {name: body lines})."""
    comps: dict[str, list[str]] = {}
    entry = None
    cur: list[str] | None = None
    for line in hlo_text.splitlines():
        s = line.strip()
        if cur is None:
            # a computation header is the only `{`-terminated line outside a
            # body; params may nest parens (tuple types), so match loosely
            if s.endswith("{") and " = " not in s:
                m = _COMP_START_RE.match(s)
                if m:
                    name = m.group(2)
                    comps[name] = cur = []
                    if m.group(1):
                        entry = name
            continue
        if s == "}" or s.startswith("} "):
            cur = None
        else:
            cur.append(s)
    return entry, comps


def collective_bytes(hlo_text: str) -> dict[str, dict[str, dict[str, float]]]:
    """Per-collective-kind {count, bytes} from optimized HLO text, split
    into the UNCONDITIONALLY executed program ('steady') and computations
    reachable only through ``conditional`` branches ('conditional' — e.g.
    the exchange resort's guarded stock-sort fallback, which executes only
    on seam-guard trips and must not be billed to the steady-state step).

    Bytes = the op's OUTPUT bytes (per device, since SPMD HLO is the
    per-device program) — for permute/gather that is what crosses the
    link; all-reduce moves ~2x in a ring, noted by the caller."""
    entry, comps = _parse_computations(hlo_text)

    def refs(body, patterns):
        out = set()
        for line in body:
            for pat in patterns:
                for mm in pat.finditer(line):
                    out.add(mm.group(1))
            if patterns is _COND_REF_RES:
                for mm in _COND_BRANCHES_RE.finditer(line):
                    for nm in mm.group(1).split(","):
                        out.add(nm.strip().lstrip("%"))
        return {r for r in out if r in comps}

    # closure of unconditional reachability from the entry
    steady: set[str] = set()
    stack = [entry] if entry in comps else list(comps)[-1:]
    while stack:
        c = stack.pop()
        if c in steady:
            continue
        steady.add(c)
        stack.extend(refs(comps[c], _UNCOND_REF_RES))
    # everything else reachable (through conditional branches) is 'conditional'
    reachable: set[str] = set(steady)
    stack = list(steady)
    while stack:
        c = stack.pop()
        for r in refs(comps[c], _COND_REF_RES) | refs(comps[c], _UNCOND_REF_RES):
            if r not in reachable:
                reachable.add(r)
                stack.append(r)

    out = {"steady": {}, "conditional": {}}
    for name in reachable:
        bucket = out["steady"] if name in steady else out["conditional"]
        for line in comps[name]:
            m = _COLLECTIVE_RE.match(line)
            if not m:
                continue
            d = bucket.setdefault(m.group(2), {"count": 0, "bytes": 0})
            d["count"] += 1
            d["bytes"] += _shape_bytes(m.group(1))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--radius", type=float, default=0.02)
    ap.add_argument("--resort", type=int, default=2)
    ap.add_argument("--extent", type=float, default=1.0,
                    help="stretch the domain/fluid in x by this factor "
                    "(a long channel keeps the exchange-resort edge and "
                    "the 1-D halo below shard_rows — the production "
                    "regime, VERDICT r4 #2)")
    ap.add_argument("--mesh2d", default=None, metavar="SXxSY[xSZ]",
                    help="measure the rectangle decomposition "
                    "(ShardedWCSPHRect) on an SXxSY (or SXxSYxSZ box) mesh "
                    "instead of the 1-D slab solver")
    args = ap.parse_args()

    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={args.devices}"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    import tisph as tt
    from tisph.ops.neighbors import SweepConfig
    from tisph.parallel import (
        ShardedWCSPH, ShardedWCSPHRect, make_mesh, make_mesh2d, make_mesh3d,
    )

    ex = args.extent
    scene = tt.scene_from_dict({
        "configuration": {
            "dim": 3, "domainStart": [0.0, 0.0, 0.0],
            "domainEnd": [ex, 1.0, 1.0], "particleRadius": args.radius,
            "density0": 1000, "gravitation": [0.0, -9.81, 0.0], "c_s": 50.0,
        },
        "fluidBlocks": [
            {"start": [0.1, 0.1, 0.1], "end": [ex - 0.1, 0.6, 0.9],
             "velocity": [0.0, -0.5, 0.2], "density": 1000.0,
             "color": [50, 100, 200]}
        ],
        "rigidBodies": [],
    })
    if args.mesh2d:
        try:
            sizes = tuple(map(int, args.mesh2d.lower().split("x")))
        except ValueError:
            sizes = ()
        if len(sizes) not in (2, 3) or any(s < 1 for s in sizes):
            raise SystemExit(f"--mesh2d expects SXxSY or SXxSYxSZ (e.g. 4x2 "
                             f"or 2x2x2), got {args.mesh2d!r}")
        if int(np.prod(sizes)) != args.devices:
            raise SystemExit(f"--mesh2d {args.mesh2d} != {args.devices} devices")
        mesh2 = (make_mesh2d(*sizes) if len(sizes) == 2
                 else make_mesh3d(*sizes))
        cfg = SweepConfig(
            impl="pallas", block_size=128, window_cap=1152,
            interpret=True, resort_every=args.resort,
        )
        solver = ShardedWCSPHRect(scene, mesh2, sweep_cfg=cfg)
        state = solver.bind(tt.build_state(scene))
        import jax.numpy as jnp
        n = int(jax.device_get(jnp.sum(state.material != -1)))
        res = {"devices": args.devices, "mesh2d": list(sizes)}

        def report(name, fn, nsub):
            compiled = jax.jit(fn).lower(state).compile()
            cb = collective_bytes(compiled.as_text())
            steady = sum(d["bytes"] for d in cb["steady"].values())
            fallback = sum(d["bytes"] for d in cb["conditional"].values())
            print(f"-- {name} (per device, per dispatch):")
            for k, d in sorted(cb["steady"].items()):
                print(f"   {k:<20s} x{int(d['count']):3d}  "
                      f"{d['bytes'] / 1e6:8.3f} MB")
            print(f"   TOTAL {steady / 1e6:.3f} MB  "
                  f"(per substep: {steady / 1e6 / nsub:.3f} MB; "
                  f"+{fallback / 1e6:.3f} MB in conditional branches)")
            return ({k: d["bytes"] for k, d in cb["steady"].items()}
                    | {"total": steady, "fallback_branch": fallback})

        caps = {f"cap_h{L}": getattr(solver, f"cap_h{L}")
                for L in solver._letters}
        print(f"== rect mesh {'x'.join(map(str, sizes))}: particles={n} "
              f"shard_rows={solver._shard_rows} bufs "
              + " ".join(f"H{L}={v}" for L, v in
                         zip(solver._letters, caps.values())))
        rm = {"particles": n, "shard_rows": solver._shard_rows, **caps}
        rm["step"] = report("full step (R=1)", solver._step_fn, 1)
        R = args.resort
        if R > 1:
            def group(s):
                s, cache = solver._seg_build(s)
                for _ in range(R):
                    s = solver._seg_apply(s, cache)
                return s

            rm[f"group_R{R}"] = report(
                f"R={R} group (build + {R} substeps)", group, R)
        res["mesh2d_result"] = rm
        print(json.dumps(res))
        return

    mesh = make_mesh(args.devices)
    res = {"devices": args.devices}
    for mode in ("global", "exchange"):
        cfg = SweepConfig(
            impl="pallas", block_size=128, window_cap=1152,
            interpret=True, resort_every=args.resort,
        )
        solver = ShardedWCSPH(scene, mesh, sweep_cfg=cfg, resort=mode)
        state = solver.bind(tt.build_state(scene))
        n = int(jax.device_get(state.num_active))
        hops = solver._hops()
        n_per = state.capacity // args.devices

        def report(name, fn, nsub):
            compiled = jax.jit(fn).lower(state).compile()
            cb = collective_bytes(compiled.as_text())
            steady = sum(d["bytes"] for d in cb["steady"].values())
            fallback = sum(d["bytes"] for d in cb["conditional"].values())
            print(f"-- {name} (per device, per dispatch):")
            for k, d in sorted(cb["steady"].items()):
                print(f"   {k:<20s} x{int(d['count']):3d}  "
                      f"{d['bytes'] / 1e6:8.3f} MB")
            print(f"   TOTAL {steady / 1e6:.3f} MB  "
                  f"(per substep: {steady / 1e6 / nsub:.3f} MB; "
                  f"+{fallback / 1e6:.3f} MB in guarded fallback branches)")
            return ({k: d["bytes"] for k, d in cb["steady"].items()}
                    | {"total": steady, "fallback_branch": fallback})

        print(f"== resort={mode}: devices={args.devices}  particles={n}  "
              f"capacity={state.capacity}  per-shard={n_per}  "
              f"halo={solver.halo} rows  hops={hops}  "
              f"edge={solver.resort_edge}")
        rm = {
            "particles": n, "per_shard": n_per,
            "halo_rows": int(solver.halo), "hops": int(hops),
            "resort_edge": int(solver.resort_edge or 0),
        }
        rm["step"] = report("full step (R=1)", solver._step_fn, 1)
        R = args.resort
        if R > 1:
            def group(s):
                s, cache = solver._seg_build(s)
                for _ in range(R):
                    s = solver._seg_apply(s, cache)
                return s

            rm[f"group_R{R}"] = report(
                f"R={R} group (build + {R} substeps)", group, R)
        res[mode] = rm
    print(json.dumps(res))


if __name__ == "__main__":
    main()
