"""Scene geometry: lattice samplers, mesh loading + voxelization, emitters.

Host-side preprocessing (numpy) done once at build time, results shipped to
device — replacing the reference's trimesh path (partice_systemv4.py:259-277)
which is re-run twice per scene (SURVEY.md §3.3); here it is cached.
"""

from tisph.geometry.sampler import cube_lattice
from tisph.geometry.builder import build_state
from tisph.geometry.mesh import TriMesh, load_obj
from tisph.geometry.voxelize import voxelize_points
