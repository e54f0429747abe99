"""Full-state checkpoint / resume.

The reference cannot restart a run: its only export (``dump()``,
partice_systemv4.py:279-296) drops density/pressure/volume (SURVEY.md §5.4).
Here the complete SimState pytree round-trips:

- ``save_npz`` / ``load_npz``: single-file numpy archive (portable,
  dependency-free);
- ``save_orbax`` / ``load_orbax``: orbax-checkpoint directory format (for
  async, sharded, or cloud-storage checkpoints), gated on orbax being
  importable.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np

from tisph.models.state import SimState


def save_npz(state: SimState, path: str | os.PathLike, rigid=None,
             emitters=None) -> None:
    """``rigid``: optional RigidState — dynamic-body momentum (v_com,
    omega) is NOT derivable from the particle snapshot (make_rigid_state
    zero-initialises it), so rigid scenes must checkpoint it alongside.

    ``emitters``: optional sequence of EmitterState — the interval
    counters (``step``) and ``emitted`` totals are likewise not derivable
    from the particle snapshot; resuming without them silently resets the
    emission cadence (VERDICT r4 #6)."""
    host = {k: np.asarray(v) for k, v in jax.device_get(dataclasses.asdict(state)).items()}
    if rigid is not None:
        host.update({
            f"rigid__{k}": np.asarray(v)
            for k, v in jax.device_get(dataclasses.asdict(rigid)).items()
        })
    for i, es in enumerate(emitters or ()):
        host.update({
            f"emitter{i}__{k}": np.asarray(v)
            for k, v in jax.device_get(dataclasses.asdict(es)).items()
        })
    np.savez_compressed(os.fspath(path), **host)


def load_npz(path: str | os.PathLike, with_rigid: bool = False,
             with_emitters: bool = False):
    """Returns the SimState, extended by ``RigidState | None`` when
    ``with_rigid`` and by ``list[EmitterState]`` when ``with_emitters``
    (empty if the archive carries no emitter fields)."""
    with np.load(os.fspath(path)) as z:
        fields = {k: jnp.asarray(z[k]) for k in z.files
                  if "__" not in k}
        rfields = {k[len("rigid__"):]: jnp.asarray(z[k]) for k in z.files
                   if k.startswith("rigid__")}
        efields: dict[int, dict] = {}
        for k in z.files:
            if k.startswith("emitter"):
                head, name = k.split("__", 1)
                efields.setdefault(int(head[len("emitter"):]), {})[name] = (
                    jnp.asarray(z[k])
                )
    state = SimState(**fields)
    out = [state]
    if with_rigid:
        if rfields:
            from tisph.models.rigid import RigidState

            out.append(RigidState(**rfields))
        else:
            out.append(None)
    if with_emitters:
        from tisph.geometry.emitter import EmitterState

        out.append([EmitterState(**efields[i]) for i in sorted(efields)])
    return out[0] if len(out) == 1 else tuple(out)


def save_orbax(state: SimState, path: str | os.PathLike) -> None:
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(os.path.abspath(os.fspath(path)), state)


def load_orbax(path: str | os.PathLike, like: SimState) -> SimState:
    """Restore; ``like`` provides the pytree structure/shapes."""
    import orbax.checkpoint as ocp

    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(os.path.abspath(os.fspath(path)), like)
