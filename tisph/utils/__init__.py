"""Utilities: union-find clustering, domain wireframes, metrics, profiling."""

from tisph.utils.dsu import DSU, cluster_points
from tisph.utils.lines import domain_wireframe
