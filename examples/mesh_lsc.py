"""BASELINE config #5: a large coated LSC with MESH geometry and edge
solar cells, traced on the device engine.

The concentrator is a hexagonal plate (a closed 24-triangle mesh, the
kind of shape the reference could only express through trimesh,
reference geometry/mesh.py:44-61) with:

* Lumogen-like dye + background absorber in the bulk,
* a perfect back-surface mirror (facet override on the bottom faces,
  cf. reference device/lsc.py:290 add_back_surface_mirror),
* ideal index-matched solar cells on all six edge facets (facet
  override ABSORB, cf. reference device/lsc.py:22-88),
* edge recorders counting collected photons per cell facet.

Run:  python examples/mesh_lsc.py [n_photons]
"""
import functools
import sys

import numpy as np

from pvtrace_tpu import (
    Absorber,
    Light,
    Luminophore,
    Material,
    Node,
    Scene,
    Sphere,
    cone,
    lumogen_f_red_305,
)
from pvtrace_tpu.geometry.mesh import Mesh
from pvtrace_tpu.light.light import ConstantWavelengthMask
from pvtrace_tpu.material.surface import (
    OVERRIDE_ABSORB,
    OVERRIDE_MIRROR,
    FacetOverride,
    FacetOverrideSurfaceDelegate,
    Surface,
)


def hex_plate(radius=4.0, thickness=1.0):
    """Closed hexagonal-plate triangle mesh with outward-facing windings."""
    ang = np.arange(6) * np.pi / 3.0
    h = 0.5 * thickness
    ring = np.column_stack([radius * np.cos(ang), radius * np.sin(ang)])
    vertices = np.vstack(
        [
            [0.0, 0.0, h], [0.0, 0.0, -h],
            np.column_stack([ring, np.full(6, h)]),
            np.column_stack([ring, np.full(6, -h)]),
        ]
    )
    faces = []
    for k in range(6):
        k2 = (k + 1) % 6
        faces.append((0, 2 + k, 2 + k2))          # top fan (+z)
        faces.append((1, 8 + k2, 8 + k))          # bottom fan (-z)
        faces.append((2 + k, 8 + k, 8 + k2))      # side lower
        faces.append((2 + k, 8 + k2, 2 + k2))     # side upper
    faces = np.asarray(faces, dtype=np.int64)
    # Enforce outward windings (the plate is star-shaped about origin)
    v0 = vertices[faces[:, 0]]
    n = np.cross(
        vertices[faces[:, 1]] - v0, vertices[faces[:, 2]] - v0
    )
    centroids = vertices[faces].mean(axis=1)
    flip = np.einsum("ij,ij->i", n, centroids) < 0
    faces[flip] = faces[flip][:, [0, 2, 1]]
    return vertices, faces


def edge_normals():
    """Outward normals of the six edge facets (local frame)."""
    ang = np.arange(6) * np.pi / 3.0 + np.pi / 6.0
    return [(float(np.cos(a)), float(np.sin(a)), 0.0) for a in ang]


def build_mesh_lsc(radius=4.0, thickness=1.0, dye_peak=5.0, bg=0.1):
    from pvtrace_tpu.engine.recorder import Recorder

    x = np.arange(400, 801, dtype=float)
    overrides = [FacetOverride((0.0, 0.0, -1.0), OVERRIDE_MIRROR, atol=1e-3)]
    overrides += [
        FacetOverride(nrm, OVERRIDE_ABSORB, atol=1e-3)
        for nrm in edge_normals()
    ]
    world = Node(
        name="world",
        geometry=Sphere(
            radius=radius * 25.0, material=Material(refractive_index=1.0)
        ),
    )
    plate = Node(
        name="plate",
        parent=world,
        geometry=Mesh(
            hex_plate(radius, thickness),
            material=Material(
                refractive_index=1.5,
                surface=Surface(
                    delegate=FacetOverrideSurfaceDelegate(overrides)
                ),
                components=[
                    Luminophore(
                        np.column_stack(
                            (x, dye_peak * lumogen_f_red_305.absorption(x))
                        ),
                        emission=np.column_stack(
                            (x, lumogen_f_red_305.emission(x))
                        ),
                        quantum_yield=0.95,
                        name="dye",
                    ),
                    Absorber(bg, name="background"),
                ],
            ),
        ),
    )
    plate.recorders = [
        Recorder(f"cell_{i}", event="escaping", facet=nrm, atol=1e-3)
        for i, nrm in enumerate(edge_normals())
    ] + [Recorder("incident", event="entering", facet=(0.0, 0.0, 1.0))]
    light = Node(
        name="light",
        parent=world,
        light=Light(
            direction=functools.partial(cone, np.radians(20)),
            wavelength=ConstantWavelengthMask(555.0),
        ),
    )
    light.translate((0.0, 0.0, thickness * 2.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return Scene(world)


def main():
    from pvtrace_tpu import engine
    from pvtrace_tpu.light.event import Event

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    scene = build_mesh_lsc()

    import time

    # Warm with a budget above the default lane width so the compiled
    # program (lane width = min(n, AUTO_LANES)) is the timed run's.
    engine.simulate(scene, min(n, 2_000_000), seed=1, record_every=0)
    tic = time.perf_counter()
    result = engine.simulate(scene, n, seed=7, record_every=0)
    dt = time.perf_counter() - tic

    fates = result.fate_counts()
    recs = result.recorders
    incident = recs["incident"].rays
    collected = sum(recs[f"cell_{i}"].rays for i in range(6))
    print(f"{n:,} photons in {dt:.2f}s -> {n / dt:,.0f} photons/s")
    for event, count in sorted(fates.items(), key=lambda kv: -kv[1]):
        name = event.name if isinstance(event, Event) else event
        print(f"  {name:14s} {count:>12,}  ({count / n:.4f})")
    print(f"  incident       {incident:>12,}")
    print(
        f"  edge-collected {collected:>12,}  "
        f"(optical efficiency {collected / max(incident, 1):.4f})"
    )


if __name__ == "__main__":
    main()
