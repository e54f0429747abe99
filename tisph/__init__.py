"""tisph — a smoothed-particle-hydrodynamics (SPH) framework on JAX.

A ground-up rebuild of the capabilities of the Ti-SPH reference (a Taichi
WCSPH fluid simulator): JAX/XLA for the compute graph, sort-based cell
binning, Pallas GPU kernels (Triton route) for the fused neighbor sweeps,
and ``shard_map`` spatial domain decomposition for multi-device scaling.

Layer map (mirrors reference layers reconstructed in SURVEY.md §1):

- ``tisph.config``    — scene/config schema (reference: data/scenes/*.json)
- ``tisph.geometry``  — samplers, mesh load + voxelize (reference: trimesh path)
- ``tisph.ops``       — grid/neighbor/force device ops (reference: @ti.kernel tier)
- ``tisph.models``    — solvers: WCSPH et al (reference: core/sph/)
- ``tisph.parallel``  — multi-chip domain decomposition (new capability)
- ``tisph.render``    — frame export, viewers, BPA surface reconstruction
- ``tisph.utils``     — metrics, profiling, wireframes, DSU
"""

from tisph.version import __version__
from tisph.config import SceneConfig, SolverParams, load_scene, scene_from_dict
from tisph.models.state import SimState, MATERIAL_BOUNDARY, MATERIAL_FLUID, MATERIAL_INVALID
from tisph.models.wcsph import WCSPH
from tisph.models.wcsph_legacy import WCSPHLegacy
from tisph.models.wcsph_rigid import WCSPHRigid
from tisph.geometry.builder import build_state

__all__ = [
    "__version__",
    "SceneConfig",
    "SolverParams",
    "load_scene",
    "scene_from_dict",
    "SimState",
    "MATERIAL_BOUNDARY",
    "MATERIAL_FLUID",
    "MATERIAL_INVALID",
    "WCSPH",
    "WCSPHLegacy",
    "WCSPHRigid",
    "build_state",
]
