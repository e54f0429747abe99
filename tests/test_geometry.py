"""Geometry tests: lattice sampler parity with the reference's arange
semantics, OBJ round-trip, and solid voxelization sanity."""

import numpy as np
import pytest

from tisph.geometry.sampler import cube_lattice, count_cube_particles
from tisph.geometry.mesh import (
    TriMesh,
    box_mesh,
    load_obj,
    rotation_matrix,
    save_obj,
    sphere_mesh,
)
from tisph.geometry.voxelize import voxelize_points, voxelize_solid


def test_cube_lattice_matches_reference_arange():
    """Reference add_cube: np.arange(start, end, radius) per axis
    (partice_systemv4.py:347-373)."""
    start, end, r = [0.3, 0.1, 0.7], [1.0, 1.0, 1.0], 0.01
    pts = cube_lattice(start, end, r)
    expect = [len(np.arange(s, e, r)) for s, e in zip(start, end)]
    assert pts.shape == (int(np.prod(expect)), 3)
    assert count_cube_particles(start, end, r) == pts.shape[0]
    # corner particle sits exactly at start
    assert np.allclose(pts.min(axis=0), start, atol=1e-6)
    # spacing is exactly r along each axis
    xs = np.unique(pts[:, 0])
    assert np.allclose(np.diff(xs), r, atol=1e-5)


def test_cube_lattice_2d_and_transforms():
    pts = cube_lattice([0.0, 0.0], [0.1, 0.1], 0.05, translation=[1.0, 2.0])
    assert pts.shape == (4, 2)
    assert np.allclose(pts.min(axis=0), [1.0, 2.0], atol=1e-6)
    scaled = cube_lattice([0.0, 0.0], [0.2, 0.2], 0.05, scale=[0.5, 0.5])
    assert scaled[:, 0].max() < 0.1


def test_rotation_matrix():
    r = rotation_matrix(np.pi / 2, [0, 0, 1])
    np.testing.assert_allclose(r @ [1, 0, 0], [0, 1, 0], atol=1e-12)
    assert np.allclose(rotation_matrix(1.0, [0, 0, 0]), np.eye(3))


def test_obj_roundtrip(tmp_path):
    mesh = box_mesh([0, 0, 0], [1, 2, 3])
    p = tmp_path / "box.obj"
    save_obj(mesh, p)
    loaded = load_obj(p)
    np.testing.assert_allclose(loaded.vertices, mesh.vertices)
    np.testing.assert_array_equal(loaded.faces, mesh.faces)


def test_obj_quad_and_slash_syntax(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vn 0 0 1\n"
        "f 1//1 2//1 3//1 4//1\n"
    )
    mesh = load_obj(p)
    assert mesh.vertices.shape == (4, 3)
    assert mesh.faces.shape == (2, 3)  # quad fan-triangulated


def test_voxelize_box_volume():
    mesh = box_mesh([0, 0, 0], [0.4, 0.4, 0.4])
    pitch = 0.05
    pts = voxelize_points(mesh, pitch)
    # Faces lie exactly on gridlines, so the surface marks voxels on both
    # sides: count lands between 8^3 (interior-tight) and 10^3 (one-voxel
    # dilated shell).
    assert 512 <= pts.shape[0] <= 1000
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    assert (lo > -1.5 * pitch).all() and (hi < 0.4 + 1.5 * pitch).all()


def test_voxelize_sphere_fills_interior():
    mesh = sphere_mesh([0.5, 0.5, 0.5], 0.2, subdiv=2)
    pitch = 0.04
    filled, origin = voxelize_solid(mesh, pitch)
    pts = voxelize_points(mesh, pitch)
    expected = (4 / 3) * np.pi * 0.2**3 / pitch**3
    assert abs(pts.shape[0] - expected) / expected < 0.4
    # center voxel is filled (interior fill worked, not just the shell)
    cidx = np.floor((np.array([0.5, 0.5, 0.5]) - origin) / pitch).astype(int)
    assert filled[tuple(cidx)]


def test_mesh_transform_pipeline():
    """scale -> rotate about centroid -> translate, as in
    partice_systemv4.py:259-277."""
    mesh = box_mesh([0, 0, 0], [1, 1, 1])
    centroid0 = mesh.vertices.mean(axis=0)
    mesh.apply_scale([2, 1, 1]).apply_rotation(90, [0, 0, 1]).apply_translation([5, 0, 0])
    lo, hi = mesh.bounds
    # after x-scale 2 and 90deg z-rotation, extent is 1 x 2 x 1
    np.testing.assert_allclose(hi - lo, [1, 2, 1], atol=1e-9)
    assert lo[0] > 4.0


def test_voxelize_open_mesh_leak_recovery():
    """A sphere with a hole punched in it leaks the exterior flood; the
    voxelizer must detect the leak and recover the interior by closing."""
    from tisph.geometry.mesh import TriMesh

    mesh = sphere_mesh([0.5, 0.5, 0.5], 0.2, subdiv=3)
    # punch a hole: drop every face whose centroid is in the +z polar cap
    cent = mesh.vertices[mesh.faces].mean(axis=1)
    keep = cent[:, 2] < 0.5 + 0.19
    open_mesh = TriMesh(mesh.vertices.copy(), mesh.faces[keep].copy())
    assert keep.sum() < len(mesh.faces)  # the hole exists

    pitch = 0.04
    filled, origin = voxelize_solid(open_mesh, pitch)
    cidx = np.floor((np.array([0.5, 0.5, 0.5]) - origin) / pitch).astype(int)
    assert filled[tuple(cidx)]  # interior recovered despite the hole
    expected = (4 / 3) * np.pi * 0.2**3 / pitch**3
    assert filled.sum() > 0.5 * expected


def test_dragon_mesh_ingestion():
    """Reference-scale scanned mesh (25k vertices, 50k faces — the asset the
    reference voxelizes at partice_systemv4.py:259-277): loads, voxelizes
    with a real interior, and lands inside its own bounds."""
    mesh = load_obj("scenes/assets/Dragon_50k.obj")
    assert mesh.vertices.shape[0] >= 25000
    assert mesh.faces.shape[0] >= 50000
    pitch = float((mesh.bounds[1] - mesh.bounds[0]).max()) / 50
    filled, origin = voxelize_solid(mesh, pitch)
    pts = voxelize_points(mesh, pitch)
    # shell alone would be ~O(surface/pitch^2) ~ 4k voxels; a filled body is
    # far denser.  Interior must be nonempty (no leak).
    from tisph.geometry.voxelize import _rasterize_surface
    surf = _rasterize_surface(mesh, origin, pitch, filled.shape)
    assert filled.sum() > surf.sum()  # interior recovered
    lo, hi = mesh.bounds
    assert (pts.min(axis=0) >= lo - 2 * pitch).all()
    assert (pts.max(axis=0) <= hi + 2 * pitch).all()


def test_dragon_scene_builds():
    """The 500k bench scene ingests the Dragon as boundary particles."""
    import tisph as tt

    scene = tt.load_scene("scenes/bench_3d_mesh_500k.json")
    from tisph.geometry.builder import load_rigid_points

    pts = load_rigid_points(scene.rigid_bodies[0], scene)
    assert pts.shape[0] > 10000  # dragon at diameter pitch ~= 16k seeds
    # inside the translated dragon bbox, which sits inside the domain
    assert (pts[:, 0] > 1.5).all() and (pts[:, 0] < 3.2).all()
    assert (pts[:, 1] > -0.05).all() and (pts[:, 1] < 1.0).all()
