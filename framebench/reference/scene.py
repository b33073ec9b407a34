"""The demo scene's start, built here from the demo's published layout and
not taken from the program: the reference renders and steps this one, and
the check compares the program's start against it (``start_gap``).

The layout (MyScene.ixx:52-303): four hero spheres; the oscillator field,
a jittered lattice of cells (i, j) in [-g, g]^2 drawn from
``numpy.random.RandomState(layout_seed)``, each cell at x = i + 0.7 u,
z = j - 0.7 u, y on its spring at t = 0, skipped within 1 m of a hero,
with a material drawn from the same stream (diffuse, metal, glass or
emissive); the moon on its circular orbit about the earth; the earth
turning; the star, a static mirror of radius 50 under the floor. Every
material constant is the demo's (Material.ixx defaults where it sets
none), and textures are not loaded (every map falls back to its
constant). Values are float64.
"""

from __future__ import annotations

import math

import numpy as np

GRAVITATIONAL_CONSTANT = 6.674e-11       # PhysX.h:14
SPRING_PERIOD = 3.0                      # MyScene.ixx:48
SPRING_REST_Y = 0.5
SPRING_AMPLITUDE = 0.5                   # MyScene.ixx:173
OSCILLATOR_RADIUS = 0.075
HEROES = (((-2.0, 0.5, 0.0), dict(base=(1, 1, 1), metallic=1.0,
                                  roughness=1.0)),
          ((0.0, 0.5, 0.0), dict(base=(1, 1, 1), roughness=0.0,
                                 transmission=1.0)),
          ((0.0, 2.0, 0.0), dict(base=(1, 1, 1), roughness=0.5,
                                 transmission=1.0)),
          ((2.0, 0.5, 0.0), dict(base=(0.7, 0.6, 0.5), metallic=1.0,
                                 roughness=0.3)))
MOON, EARTH, STAR = (-4.0, 4.0, 0.0), (0.0, 4.0, 0.0), (0.0, -50.1, 0.0)
MOON_ORBIT_S, EARTH_TURN_S = 10.0, 15.0
START_KEYS = ("radius", "base_color", "emission", "metallic", "roughness",
              "ior", "transmission", "bodies")


def _material(base=(0, 0, 0), emissive_strength=1.0, emissive=(0, 0, 0),
              metallic=0.0, roughness=0.5, ior=1.5, transmission=0.0):
    return {"base_color": tuple(base)[:3],
            "emission": tuple(emissive_strength * np.asarray(emissive,
                                                             float)),
            "metallic": metallic, "roughness": roughness, "ior": ior,
            "transmission": transmission}


def demo_start(layout_seed: int = 0, oscillator_grid: int = 10) -> dict:
    """The scene's materials and rigid bodies at t = 0, keyed as the
    reference reads them."""
    rng = np.random.RandomState(layout_seed)
    omega = 2.0 * math.pi / SPRING_PERIOD
    rows = []            # (position, radius, material, velocity, spin, mass)

    def add(pos, radius, mat, velocity=(0, 0, 0), spin=0.0, mass=None):
        rows.append((pos, radius, mat, velocity, spin,
                     4.0 / 3.0 * math.pi * radius ** 3 if mass is None
                     else mass))

    for pos, mat in HEROES:
        add(pos, 0.5, _material(**mat))
    g = int(oscillator_grid)
    heroes = np.array([p for p, _ in HEROES])
    for i in range(-g, g + 1):
        for j in range(-g, g + 1):
            x = i + 0.7 * rng.random_sample()
            z = j - 0.7 * rng.random_sample()
            y = SPRING_REST_Y + SPRING_AMPLITUDE * math.cos(-x)
            if np.linalg.norm(heroes - np.array([x, y, z]), axis=1).min() \
                    < 1.0:
                continue

            def colour(lo=0.1):
                return lo + (1.0 - lo) * rng.random_sample(3)
            kind = rng.random_sample()
            if kind < 0.3:
                mat = _material(base=colour())
            elif kind < 0.6:
                mat = _material(base=colour(), metallic=1.0,
                                roughness=0.5 * rng.random_sample())
            elif kind < 0.8:
                mat = _material(base=colour(),
                                roughness=0.5 * rng.random_sample(),
                                transmission=1.0)
            else:
                base = colour()
                strength = 1.0 + 9.0 * rng.random_sample()
                emissive = 0.2 + 0.8 * rng.random_sample(3)
                mat = _material(base=base, emissive_strength=strength,
                                emissive=emissive,
                                metallic=0.4 + 0.6 * rng.random_sample(),
                                roughness=0.3 + 0.7 * rng.random_sample())
            vy = -SPRING_AMPLITUDE * omega * math.sin(-x)
            add((x, y, z), OSCILLATOR_RADIUS, mat, velocity=(0, vy, 0))

    # The moon on a circular orbit of radius r about the earth: the earth's
    # mass from the orbit's period, the moon at the first cosmic speed,
    # turning once an orbit.
    r = float(np.linalg.norm(np.subtract(MOON, EARTH)))
    earth_mass = 4.0 * math.pi ** 2 * r ** 3 / (
        GRAVITATIONAL_CONSTANT * MOON_ORBIT_S ** 2)
    speed = math.sqrt(GRAVITATIONAL_CONSTANT * earth_mass / r)
    to_earth = np.subtract(EARTH, MOON) / r
    add(MOON, 0.25, _material(base=(1, 1, 1), roughness=0.8),
        velocity=(-to_earth[2] * speed, 0.0, to_earth[0] * speed),
        spin=speed / r)
    add(EARTH, 1.0, _material(base=(1, 1, 1), roughness=0.8),
        spin=2.0 * math.pi / EARTH_TURN_S, mass=earth_mass)
    add(STAR, 50.0, _material(base=(0.5, 0.5, 0.5), metallic=1.0,
                              roughness=0.0), mass=0.0)

    k = len(rows)
    mats = [row[2] for row in rows]
    mass = np.array([row[5] for row in rows], float)
    radius = np.array([row[1] for row in rows], float)
    spin = np.zeros((k, 3))
    spin[:, 1] = [row[4] for row in rows]
    rotation = np.zeros((k, 4))
    rotation[:, 3] = 1.0
    n_heroes, kinds = len(HEROES), np.zeros(k, int)
    kinds[n_heroes:k - 3] = 1
    return {
        "radius": radius,
        "base_color": np.array([mt["base_color"] for mt in mats], float),
        "emission": np.array([mt["emission"] for mt in mats], float),
        "metallic": np.array([mt["metallic"] for mt in mats], float),
        "roughness": np.array([mt["roughness"] for mt in mats], float),
        "ior": np.array([mt["ior"] for mt in mats], float),
        "transmission": np.array([mt["transmission"] for mt in mats],
                                 float),
        "bodies": {
            "position": np.array([row[0] for row in rows], float),
            "velocity": np.array([row[3] for row in rows], float),
            "rotation": rotation, "angular_velocity": spin,
            "mass": mass,
            "inv_mass": np.where(mass > 0, 1.0 / np.maximum(mass, 1e-300),
                                 0.0),
            "radius": radius, "is_oscillator": kinds == 1,
            "attracted_to_earth": np.arange(k) == k - 3,
            "earth_gravity": np.array(False),
            "star_gravity": np.array(False),
            "spring_rest_y": SPRING_REST_Y, "earth_index": k - 2,
            "star_index": k - 1},
    }


def start_gap(program: dict, reference: dict) -> float:
    """The widest gap between the program's scene start and the
    reference's, each array relative to max(|reference|, 1); a different
    shape, count or flag is an infinite gap."""
    worst = 0.0
    for key, want in reference.items():
        got = program.get(key)
        if isinstance(want, dict):
            worst = max(worst, start_gap(got or {}, want))
            continue
        want = np.asarray(want)
        if got is None or np.shape(got) != want.shape:
            return float("inf")
        got = np.asarray(got)
        if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
            if not np.array_equal(got, want):
                return float("inf")
            continue
        gap = np.abs(got.astype(float) - want) / np.maximum(np.abs(want),
                                                              1.0)
        worst = max(worst, float(gap.max()) if gap.size else 0.0)
    return worst
