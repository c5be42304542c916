"""Concurrent tracing — the reference's hello_concurrent_box
(examples/hello_concurrent_box.py), two ways:

1. `Scene.simulate(..., workers=N)`: the reference API, multiprocessing
   over rays with the per-ray oracle tracer.
2. `engine.simulate`: the device wavefront — the whole bundle advances
   in lockstep on the accelerator, no processes needed. This is the
   way to run many rays and is orders of magnitude faster.
"""
import time

import numpy as np

from pvtrace_tpu import Box, Light, Material, Node, Scene, Sphere, engine

world = Node(
    name="world (air)",
    geometry=Sphere(radius=50.0, material=Material(refractive_index=1.0)),
)
box = Node(
    name="box (glass)",
    geometry=Box((10.0, 10.0, 1.0), material=Material(refractive_index=1.5)),
    parent=world,
)
light = Node(name="Light (555nm)", light=Light(), parent=world)
light.rotate(np.radians(60), (1.0, 0.0, 0.0))
scene = Scene(world)

if __name__ == "__main__":
    tic = time.perf_counter()
    results = scene.simulate(200, workers=2, seed=None)
    print(
        f"multiprocessing oracle: 200 rays in "
        f"{time.perf_counter() - tic:.2f} s"
    )

    engine.simulate(scene, 1000, seed=1, record_every=0)  # compile
    tic = time.perf_counter()
    result = engine.simulate(scene, 1_000_000, seed=2, record_every=0)
    elapsed = time.perf_counter() - tic
    print(f"device wavefront: 1,000,000 rays in {elapsed:.2f} s")
    print("fates:", dict(result.fate_counts()))
