"""Solvers ("model families"): WCSPH (flagship, reference wcsphv2 physics)
and WCSPHLegacy (reference wcsph/sph_base v1 physics)."""

from tisph.models.state import SimState
from tisph.models.wcsph import WCSPH
from tisph.models.wcsph_legacy import WCSPHLegacy
