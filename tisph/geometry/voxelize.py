"""Solid mesh voxelization (surface rasterisation + interior fill).

Replaces trimesh's ``mesh.voxelized(pitch).fill().points``
(partice_systemv4.py:276-277) with a dependency-free numpy implementation:

1. rasterise the triangle surface onto a uniform grid at ``pitch`` by
   recursive triangle subdivision (every voxel intersecting the surface to
   within ~pitch/2 gets marked);
2. flood-fill the exterior from the grid boundary (6-connectivity, via
   scipy.ndimage.label on the complement);
3. filled = surface | ~exterior; returns voxel centers.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

from tisph.geometry.mesh import TriMesh


def _rasterize_surface(mesh: TriMesh, origin: np.ndarray, pitch: float, shape: tuple[int, ...]) -> np.ndarray:
    """Mark every voxel touched by a triangle, by subdividing triangles
    until edges are below pitch/2 and binning the sample points."""
    occ = np.zeros(shape, dtype=bool)
    tris = mesh.vertices[mesh.faces]  # (F, 3, 3)
    stack = [tris]
    target = pitch * 0.5
    while stack:
        t = stack.pop()
        if t.size == 0:
            continue
        e0 = np.linalg.norm(t[:, 0] - t[:, 1], axis=1)
        e1 = np.linalg.norm(t[:, 1] - t[:, 2], axis=1)
        e2 = np.linalg.norm(t[:, 2] - t[:, 0], axis=1)
        max_e = np.maximum(e0, np.maximum(e1, e2))
        small = max_e <= target
        done = t[small]
        if done.size:
            pts = done.reshape(-1, 3)
            idx = np.floor((pts - origin) / pitch).astype(np.int64)
            np.clip(idx, 0, np.asarray(shape) - 1, out=idx)
            occ[idx[:, 0], idx[:, 1], idx[:, 2]] = True
        big = t[~small]
        if big.size:
            a, b, c = big[:, 0], big[:, 1], big[:, 2]
            ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
            stack.append(np.stack([a, ab, ca], axis=1))
            stack.append(np.stack([b, bc, ab], axis=1))
            stack.append(np.stack([c, ca, bc], axis=1))
            stack.append(np.stack([ab, bc, ca], axis=1))
    return occ


def _flood_fill(surface: np.ndarray) -> np.ndarray:
    """filled = surface | interior, where exterior is the complement
    component touching the grid boundary (6-connectivity)."""
    labels, _ = ndimage.label(~surface, structure=ndimage.generate_binary_structure(3, 1))
    border_labels = np.unique(
        np.concatenate(
            [labels[0].ravel(), labels[-1].ravel(),
             labels[:, 0].ravel(), labels[:, -1].ravel(),
             labels[:, :, 0].ravel(), labels[:, :, -1].ravel()]
        )
    )
    border_labels = border_labels[border_labels != 0]
    exterior = np.isin(labels, border_labels)
    return surface | ~exterior


def voxelize_solid(
    mesh: TriMesh, pitch: float, max_close_iters: int = 3
) -> tuple[np.ndarray, np.ndarray]:
    """Voxelize a mesh; returns (filled_mask, origin).

    Robust to non-watertight input (scanned meshes like Dragon_50k.obj have
    non-manifold edges; worse ones have open boundary loops): if the
    exterior flood LEAKS through a hole, the fill recovers no interior at
    all — detected as interior == 0 on a mesh whose bounding box clearly
    encloses volume — and the surface shell is morphologically closed
    (dilate+erode, growing radius) until an interior appears.  trimesh's
    ``.fill()`` (the reference's path, partice_systemv4.py:276) silently
    returns the leaked shell instead."""
    lo, hi = mesh.bounds
    # One-voxel margin so the exterior flood fill can wrap around the mesh.
    origin = lo - pitch
    shape = tuple(int(np.ceil((h - o) / pitch)) + 2 for o, h in zip(origin, hi))
    surface = _rasterize_surface(mesh, origin, pitch, shape)
    filled = _flood_fill(surface)
    interior = int(filled.sum()) - int(surface.sum())
    if interior == 0 and min(shape) >= 6:
        # leak: close holes on a padded copy (dilation must not touch the
        # array border, or the exterior seed itself gets walled off)
        for it in range(1, max_close_iters + 1):
            closed = ndimage.binary_closing(
                np.pad(surface, it + 1), iterations=it
            )[tuple([slice(it + 1, -(it + 1))] * 3)]
            filled_c = _flood_fill(closed)
            if int(filled_c.sum()) > int(closed.sum()):
                # keep the original (un-dilated) shell; add the recovered
                # interior so seeded particles don't bulge past the surface
                filled = surface | (filled_c & ~closed)
                break
    return filled, origin


def voxelize_points(mesh: TriMesh, pitch: float) -> np.ndarray:
    """Filled-voxel centers — the particle seeds for a rigid body
    (counterpart of trimesh VoxelGrid.points at pitch = particle diameter,
    partice_systemv4.py:276)."""
    filled, origin = voxelize_solid(mesh, pitch)
    idx = np.argwhere(filled)
    return (origin + (idx + 0.5) * pitch).astype(np.float32)
