"""The demo scene (port of ``drts_tpu/models/myscene.py``): 4 hero spheres,
a harmonic-oscillator field and a Moon/Earth/Star system, built host-side
from the same numpy ``RandomState`` stream as the reference, so its arrays
equal the reference build exactly. ``load_textures`` wires the reference's
texture files where they are present (models/assets.py; absent, every map
falls back to its material constant, as in the reference), and
``env_map_path`` a lat-long EXR environment map. ``add_mesh_content``
adds three textured geosphere instances (bare metal, a checker and an
alpha-tested cutout checker, baked in numpy); ``as_mesh_scene`` turns the
scene into instances of one geosphere mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import backend
from ..ops import sky
from ..ops.physics import (SPRING_PERIOD, RigidBodies, first_cosmic_speed,
                           gravitational_mass)
from ..utils import math as m
from . import scene as scene_mod
from . import texpack
from .material import MaterialDesc, Materials, pack_materials

# Spring constants (MyScene.ixx:48: PositionY = 0.5; the period, 3, is
# physics.SPRING_PERIOD).
SPRING_POSITION_Y = 0.5
SPRING_AMPLITUDE = 0.5  # MyScene.ixx:173 `A`

KIND_HERO = 0
KIND_OSCILLATOR = 1
KIND_MOON = 2
KIND_EARTH = 3
KIND_STAR = 4


@dataclasses.dataclass(frozen=True)
class MySceneHost:
    """Build products: the device scene, physics state and bookkeeping."""
    scene: scene_mod.SphereScene
    bodies: RigidBodies
    kinds: np.ndarray            # (K,) int32 KIND_*
    camera_position: tuple = (0.0, 0.0, -15.0)  # MyScene.ixx:90
    camera_forward: tuple = (0.0, 0.0, 1.0)
    # Host-side raw float atlas (scene.textures carries the packed sets),
    # kept so that add_mesh_content can append maps and bake again.
    atlas: np.ndarray | None = None
    # Materials with their original atlas-slot map indices (scene.materials
    # has them rewritten to texture-set ids by texpack.build).
    raw_materials: Materials | None = None


def _simple_harmonic_displacement(a, omega, t, phi):
    return a * np.cos(omega * t - phi)


def _simple_harmonic_velocity(a, omega, t, phi):
    return -a * omega * np.sin(omega * t - phi)


def build(seed: int = 0, oscillator_grid: int = 10,
          load_textures: bool = False, env_map_path: str | None = None,
          device="cuda") -> MySceneHost:
    """Construct the demo scene (MySceneDesc ctor, MyScene.ixx:52-303).
    `oscillator_grid` is the half-extent of the oscillator lattice (10 ->
    21x21 candidate cells); shrink it for tests. `load_textures` wires the
    reference's texture files (AlienMetal, Moon, Earth maps, MyScene.ixx:
    161-165,286-294) where they load; `env_map_path` loads a lat-long EXR
    environment map (MyScene.ixx:95), else the procedural sky stands in.
    ``device`` defaults to the card (backend.device raises where there is
    none)."""
    from . import assets

    device = backend.device(device)
    atlas, tex_present = (assets.load_texture_atlas() if load_textures
                          else (None, [False] * len(assets.TEXTURE_FILES)))
    env_texture = None
    if env_map_path is not None:
        from ..utils import image as image_mod
        env_texture = image_mod.read_exr(env_map_path)
    rng = np.random.RandomState(seed)

    def slot(i):
        """Texture slot index, or -1 where that file did not load."""
        return i if (atlas is not None and tex_present[i]) else -1

    positions, radii, velocities, angular_velocities = [], [], [], []
    masses, materials, kinds = [], [], []

    def add(kind, pos, radius, mat, velocity=(0, 0, 0), angular=(0, 0, 0),
            mass=None):
        positions.append(pos)
        radii.append(radius)
        velocities.append(velocity)
        angular_velocities.append(angular)
        masses.append((4.0 / 3.0) * np.pi * radius ** 3 if mass is None
                      else mass)
        materials.append(mat)
        kinds.append(kind)

    hero_positions = [(-2.0, 0.5, 0.0), (0.0, 0.5, 0.0), (0.0, 2.0, 0.0),
                      (2.0, 0.5, 0.0)]
    hero_materials = [
        # AlienMetal (textured, MyScene.ixx:161-165)
        MaterialDesc(base_color=(1, 1, 1, 1), metallic=1.0, roughness=1.0,
                     base_color_map=slot(assets.ALIEN_BASE),
                     metallic_map=slot(assets.ALIEN_METALLIC),
                     roughness_map=slot(assets.ALIEN_ROUGH),
                     normal_map=slot(assets.ALIEN_NORMAL)),
        MaterialDesc(base_color=(1, 1, 1, 1), roughness=0.0,
                     transmission=1.0),
        MaterialDesc(base_color=(1, 1, 1, 1), roughness=0.5,
                     transmission=1.0),
        MaterialDesc(base_color=(0.7, 0.6, 0.5, 1), metallic=1.0,
                     roughness=0.3),
    ]
    for pos, mat in zip(hero_positions, hero_materials):
        add(KIND_HERO, pos, 0.5, mat)

    omega = 2.0 * np.pi / SPRING_PERIOD
    g = oscillator_grid
    for i in range(-g, g + 1):
        for j in range(-g, g + 1):
            x = float(i) + 0.7 * rng.random_sample()
            y = SPRING_POSITION_Y + _simple_harmonic_displacement(
                SPRING_AMPLITUDE, omega, 0.0, x)
            z = float(j) - 0.7 * rng.random_sample()
            pos = np.array([x, y, z])
            if min(np.linalg.norm(pos - np.array(h))
                   for h in hero_positions) < 1.0:
                continue

            def rand_color(lo):
                return tuple(lo + (1 - lo) * rng.random_sample(3)) + (1.0,)

            rv = rng.random_sample()
            if rv < 0.3:
                mat = MaterialDesc(base_color=rand_color(0.1))
            elif rv < 0.6:
                mat = MaterialDesc(base_color=rand_color(0.1), metallic=1.0,
                                   roughness=0.5 * rng.random_sample())
            elif rv < 0.8:
                mat = MaterialDesc(base_color=rand_color(0.1),
                                   roughness=0.5 * rng.random_sample(),
                                   transmission=1.0)
            else:
                mat = MaterialDesc(
                    base_color=rand_color(0.1),
                    emissive_strength=1.0 + 9.0 * rng.random_sample(),
                    emissive_color=tuple(0.2 + 0.8 * rng.random_sample(3)),
                    metallic=0.4 + 0.6 * rng.random_sample(),
                    roughness=0.3 + 0.7 * rng.random_sample())
            vy = _simple_harmonic_velocity(SPRING_AMPLITUDE, omega, 0.0, x)
            add(KIND_OSCILLATOR, tuple(pos), 0.075, mat, velocity=(0, vy, 0))

    moon_pos = np.array([-4.0, 4.0, 0.0])
    earth_pos = np.array([0.0, 4.0, 0.0])
    star_pos = np.array([0.0, -50.1, 0.0])
    moon_orbital_period = 10.0
    earth_rotation_period = 15.0
    dist = np.linalg.norm(moon_pos - earth_pos)
    earth_mass = gravitational_mass(dist, moon_orbital_period)
    to_earth = (earth_pos - moon_pos) / dist
    speed = first_cosmic_speed(earth_mass, dist)
    moon_velocity = speed * np.array([-to_earth[2], 0.0, to_earth[0]])
    add(KIND_MOON, tuple(moon_pos), 0.25,
        MaterialDesc(base_color=(1, 1, 1, 1), roughness=0.8,
                     base_color_map=slot(assets.MOON_BASE),
                     normal_map=slot(assets.MOON_NORMAL)),
        velocity=tuple(moon_velocity), angular=(0.0, speed / dist, 0.0))
    add(KIND_EARTH, tuple(earth_pos), 1.0,
        MaterialDesc(base_color=(1, 1, 1, 1), roughness=0.8,
                     base_color_map=slot(assets.EARTH_BASE),
                     normal_map=slot(assets.EARTH_NORMAL)),
        angular=(0.0, 2.0 * np.pi / earth_rotation_period, 0.0),
        mass=earth_mass)
    # Star: mass 0 -> static collider (MyScene.ixx:297 setMass(0)).
    add(KIND_STAR, tuple(star_pos), 50.0,
        MaterialDesc(base_color=(0.5, 0.5, 0.5, 1), metallic=1.0,
                     roughness=0.0), mass=0.0)

    def tensor(x, dtype=np.float32):
        return torch.from_numpy(np.array(x, dtype)).to(device)

    k = len(positions)
    center = tensor(positions)
    rotation = torch.tensor(m.QUAT_IDENTITY, device=device).repeat(k, 1)
    radius = tensor(radii)
    kinds_np = np.array(kinds, np.int32)

    env = sky.make_environment_light(
        rotation=m.quat_from_axis_angle((0.0, 1.0, 0.0), np.pi,
                                        device=device),
        texture=env_texture, device=device)
    # Bake the packed texture sets: the raw atlas stays on the host.
    raw_mats = pack_materials(materials, device)
    packed_tex, mats = texpack.build(atlas, raw_mats)
    the_scene = scene_mod.SphereScene(
        center=center, rotation=rotation, prev_center=center,
        prev_rotation=rotation, radius=radius, materials=mats, env=env,
        textures=packed_tex)

    mass = np.array(masses, np.float32)
    inv_mass = np.where(mass > 0, 1.0 / np.maximum(mass, 1e-12), 0.0)
    bodies = RigidBodies(
        position=center, velocity=tensor(velocities), rotation=rotation,
        angular_velocity=tensor(angular_velocities), mass=tensor(mass),
        inv_mass=tensor(inv_mass), radius=radius,
        is_oscillator=tensor(kinds_np == KIND_OSCILLATOR, bool),
        spring_rest_y=SPRING_POSITION_Y,
        attracted_to_earth=tensor(kinds_np == KIND_MOON, bool),
        earth_index=int(np.nonzero(kinds_np == KIND_EARTH)[0][0]),
        star_index=int(np.nonzero(kinds_np == KIND_STAR)[0][0]))
    return MySceneHost(scene=the_scene, bodies=bodies, kinds=kinds_np,
                       atlas=atlas, raw_materials=raw_mats)


def add_mesh_content(host: MySceneHost, tessellation: int = 3,
                     alpha_test: bool = True) -> MySceneHost:
    """Extend the demo scene with three instances of one geosphere mesh
    (the reference's geosphere BLAS path, MyScene.ixx:53-88 and Scene.ixx:
    225-284): gold metal, a checker-textured diffuse and an alpha-tested
    cutout checker, with two alpha-test rounds (`alpha_test`). The
    checkers are baked in numpy at the atlas size (64 without one)."""
    from ..ops import trimesh
    from . import geometry

    scene = host.scene
    dev = scene.center.device
    mesh = trimesh.make_mesh(*geometry.create_geosphere(1.0, tessellation),
                             device=dev)
    atlas = host.atlas
    s = atlas.shape[1] if atlas is not None else 64
    t0 = atlas.shape[0] if atlas is not None else 0

    # Procedural checkers: rgb, and a cutout one (alpha 0 or 1).
    yy, xx = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    checks = (((yy // max(1, s // 8)) + (xx // max(1, s // 8))) % 2) \
        .astype(np.float32)
    checker_rgb = np.stack([0.2 + 0.7 * checks, 0.7 - 0.5 * checks,
                            np.full_like(checks, 0.3),
                            np.ones_like(checks)], axis=-1)
    checker_cut = np.stack([np.full_like(checks, 0.9),
                            np.full_like(checks, 0.6),
                            np.full_like(checks, 0.2), checks], axis=-1)
    new_tex = np.stack([checker_rgb, checker_cut]).astype(np.float32)
    atlas = (np.concatenate([atlas, new_tex]) if atlas is not None
             else new_tex)

    mesh_mats = [
        MaterialDesc(base_color=(0.9, 0.7, 0.3, 1.0), metallic=1.0,
                     roughness=0.15),
        MaterialDesc(base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.6,
                     base_color_map=t0),
        MaterialDesc(base_color=(1.0, 1.0, 1.0, 1.0), roughness=0.4,
                     base_color_map=t0 + 1, alpha_cutoff=0.5),
    ]
    centers = torch.tensor([[2.5, 1.2, -5.0], [-2.5, 1.2, -5.0],
                            [0.0, 2.2, -6.0]], device=dev)
    scales = torch.tensor([0.8, 0.8, 1.0], device=dev)
    rot = torch.tensor(m.QUAT_IDENTITY, device=dev).repeat(3, 1)
    raw_base = (host.raw_materials if host.raw_materials is not None
                else scene.materials)
    all_raw = _concat_materials(raw_base, pack_materials(mesh_mats, dev))
    packed_tex, all_mats = texpack.build(atlas, all_raw)
    mi = scene_mod.MeshInstances(center=centers, rotation=rot,
                                 prev_center=centers, prev_rotation=rot,
                                 scale=scales)
    new_scene = dataclasses.replace(
        scene, materials=all_mats, textures=packed_tex, mesh=mesh,
        mesh_instances=mi, alpha_test_rounds=2 if alpha_test else 0)
    return dataclasses.replace(host, scene=new_scene, atlas=atlas,
                               raw_materials=all_raw)


def _concat_materials(a: Materials, b: Materials) -> Materials:
    return Materials(**{f.name: torch.cat([getattr(a, f.name),
                                           getattr(b, f.name)])
                        for f in dataclasses.fields(Materials)})


def as_mesh_scene(host: MySceneHost, tessellation: int = 4) -> MySceneHost:
    """The demo scene as instanced triangle meshes, the way the reference
    renders it (MyScene.ixx:56 builds one geosphere mesh; Scene.ixx:225-284
    instances it): every sphere becomes an instance of one geosphere of
    diameter 2 (scale = radius, same pose and material row), and the sphere
    table becomes empty. Physics stays sphere-based; sync_mesh_pose pushes
    a physics step's poses into the instances."""
    from ..ops import trimesh
    from . import geometry

    scene = host.scene
    dev = scene.center.device
    mesh = trimesh.make_mesh(*geometry.create_geosphere(2.0, tessellation),
                             device=dev)
    mi = scene_mod.MeshInstances(
        center=scene.center, rotation=scene.rotation,
        prev_center=scene.prev_center, prev_rotation=scene.prev_rotation,
        scale=scene.radius)
    empty3 = torch.zeros((0, 3), dtype=torch.float32, device=dev)
    empty4 = torch.zeros((0, 4), dtype=torch.float32, device=dev)
    new_scene = dataclasses.replace(
        scene, center=empty3, rotation=empty4, prev_center=empty3,
        prev_rotation=empty4,
        radius=torch.zeros((0,), dtype=torch.float32, device=dev),
        mesh=mesh, mesh_instances=mi)
    return dataclasses.replace(host, scene=new_scene)


def sync_mesh_pose(scene: scene_mod.SphereScene, centers, rotations
                   ) -> scene_mod.SphereScene:
    """Push physics poses into the mesh instances, keeping the previous
    pose (the per-frame TLAS refit of the all-mesh scene)."""
    mi = scene.mesh_instances
    new_mi = dataclasses.replace(
        mi, prev_center=mi.center, prev_rotation=mi.rotation,
        center=centers, rotation=rotations)
    return dataclasses.replace(scene, mesh_instances=new_mi)
