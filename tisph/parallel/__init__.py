"""Multi-chip scaling: spatial domain decomposition over a jax.sharding.Mesh.

A new capability — the reference is strictly single-process single-GPU
(SURVEY.md §2.5, §5.8).  The scaling story:

- the particle axis is sharded over the mesh; because state is kept
  cell-sorted with x-major flat ids, equal shards of the sorted array ARE
  spatial slabs (data parallelism whose shards coincide with a domain
  decomposition);
- the global per-step resort doubles as particle migration between shards
  (the reference's counting-sort, globally distributed);
- neighbor sweeps read one fixed-width halo slice of the sorted array from
  each neighboring shard, exchanged with ``ppermute`` over the device
  interconnect — the SPH
  analog of a ring-attention block rotation (SURVEY.md §5.7);
- global reductions (CFL, metrics) are ``psum``/``pmax`` collectives;
- for fixed-size domains whose x-resolution caps the 1-D slab count, the
  rectangle decomposition (parallel/domain2d.py) scales the shard count
  with the domain AREA (2-axis x × y mesh) or VOLUME (3-axis x × y × z)
  and shrinks halo bytes to the rectangle perimeter / box surface.
"""

from tisph.parallel.domain import ShardedWCSPH, make_mesh
from tisph.parallel.domain2d import (
    ShardedWCSPH2D, ShardedWCSPHRect, make_mesh2d, make_mesh3d,
)
