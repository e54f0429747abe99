"""Scene -> SimState builder.

Counterpart of ParticleSystemV4.__init__ + add_fluid_and_rigid
(partice_systemv4.py:8-82, :104-158): exact capacity precomputed from the
scene, rigid bodies voxelized ONCE (the reference voxelizes twice —
SURVEY.md §3.3), fluid blocks lattice-sampled at radius spacing, then one
host->device upload of the whole SoA.
"""

from __future__ import annotations

import os

import numpy as np

from tisph.config import SceneConfig, RigidBody
from tisph.geometry.mesh import load_obj
from tisph.geometry.sampler import cube_lattice
from tisph.geometry.voxelize import voxelize_points
from tisph.models.state import (
    SimState,
    MATERIAL_BOUNDARY,
    MATERIAL_FLUID,
    make_state,
    pad_capacity,
)


def load_rigid_points(rigid: RigidBody, scene: SceneConfig) -> np.ndarray:
    """Load + transform + voxelize a rigid body at pitch = particle diameter
    (partice_systemv4.py:259-277: scale -> rotate about centroid ->
    translate -> voxelized(pitch=2r).fill())."""
    path = rigid.geometry_file
    if not os.path.isabs(path):
        path = os.path.join(scene.base_dir, path)
    mesh = load_obj(path)
    mesh.apply_scale(rigid.scale if len(rigid.scale) == 3 else rigid.scale[0])
    if rigid.rotation_angle:
        mesh.apply_rotation(rigid.rotation_angle, rigid.rotation_axis)
    mesh.apply_translation(rigid.translation)
    return voxelize_points(mesh, scene.particle_diameter)


def build_state(
    scene: SceneConfig,
    extra_capacity: int = 0,
    capacity_multiple: int = 8,
) -> SimState:
    """Sample all bodies and assemble the initial SimState.

    Rigid bodies first, then fluid blocks — the reference's add order
    (partice_systemv4.py:104-146).  ``extra_capacity`` reserves inactive
    slots for emitters; when the scene declares emitters, enough pool for
    ``max_particles`` of each is reserved automatically.
    """
    dim = scene.dim
    positions, velocities, densities, materials, colors, object_ids = [], [], [], [], [], []
    next_obj = 0

    for rigid in scene.rigid_bodies:
        pts = load_rigid_points(rigid, scene)
        n = pts.shape[0]
        positions.append(pts[:, :dim])
        velocities.append(np.tile(np.asarray(rigid.velocity[:dim], np.float32), (n, 1)))
        densities.append(np.full(n, rigid.density, np.float32))
        materials.append(np.full(n, MATERIAL_BOUNDARY, np.int32))
        colors.append(np.tile(np.asarray(rigid.color, np.float32), (n, 1)))
        object_ids.append(np.full(n, next_obj, np.int32))
        next_obj += 1

    for bb in scene.boundary_blocks:
        pts = cube_lattice(bb.start, bb.end, scene.particle_diameter)
        n = pts.shape[0]
        positions.append(pts)
        velocities.append(np.zeros((n, dim), np.float32))
        densities.append(np.full(n, bb.density, np.float32))
        materials.append(np.full(n, MATERIAL_BOUNDARY, np.int32))
        colors.append(np.tile(np.asarray(bb.color, np.float32), (n, 1)))
        object_ids.append(np.full(n, next_obj, np.int32))
        next_obj += 1

    for block in scene.fluid_blocks:
        pts = cube_lattice(
            block.start, block.end, block.spacing or scene.particle_radius,
            translation=block.translation, scale=block.scale,
        )
        n = pts.shape[0]
        positions.append(pts)
        velocities.append(np.tile(np.asarray(block.velocity[:dim], np.float32), (n, 1)))
        densities.append(np.full(n, block.density, np.float32))
        materials.append(np.full(n, MATERIAL_FLUID, np.int32))
        colors.append(np.tile(np.asarray(block.color, np.float32), (n, 1)))
        object_ids.append(np.full(n, next_obj, np.int32))
        next_obj += 1

    if positions:
        x = np.concatenate(positions, axis=0)
        v = np.concatenate(velocities, axis=0)
        rho = np.concatenate(densities, axis=0)
        mat = np.concatenate(materials, axis=0)
        col = np.concatenate(colors, axis=0)
        oid = np.concatenate(object_ids, axis=0)
    else:
        x = np.zeros((0, dim), np.float32)
        v = np.zeros((0, dim), np.float32)
        rho = np.zeros((0,), np.float32)
        mat = np.zeros((0,), np.int32)
        col = np.zeros((0, 3), np.float32)
        oid = np.zeros((0,), np.int32)

    n = x.shape[0]
    pool = extra_capacity
    for em in scene.emitters:
        if em.max_particles > 0:
            pool += em.max_particles
    capacity = pad_capacity(n + pool, capacity_multiple)

    return make_state(
        positions=x,
        velocities=v,
        densities=rho,
        pressures=np.zeros(n, np.float32),
        materials=mat,
        colors=col,
        object_ids=oid,
        volume0=scene.particle_volume0,
        capacity=capacity,
    )
