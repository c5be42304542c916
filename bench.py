"""Benchmark: photons/second on the reference LSC benchmark scene.

Scene mirrors ``/root/reference/benchmarks/benchmark_engine.py:26-55``:
a 5x5x1 cm LSC slab with a Lumogen-like dye (quantum yield 0.9, peak
absorption 10 cm^-1) plus a 0.3 cm^-1 background absorber, inside a
world sphere, lit by a 555 nm cone spotlight.

Baseline: the reference's compiled Cython/OpenMP engine reaches
~460,000 rays/s on a laptop (reference README.md:170).

Needs a GPU: a rate from another platform is not reported. Prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.
"""
import functools
import json
import sys

import numpy as np

BASELINE_RAYS_PER_S = 460_000.0


def build_scene():
    from pvtrace_tpu import (
        Absorber,
        Box,
        Light,
        Luminophore,
        Material,
        Node,
        Scene,
        Sphere,
        cone,
        lumogen_f_red_305,
    )
    from pvtrace_tpu.light.light import ConstantWavelengthMask

    x = np.arange(400, 801, dtype=float)
    world = Node(
        name="world",
        geometry=Sphere(radius=25.0, material=Material(refractive_index=1.0)),
    )
    lsc = Node(
        name="lsc",
        geometry=Box(
            (5.0, 5.0, 1.0),
            material=Material(
                refractive_index=1.5,
                components=[
                    Luminophore(
                        coefficient=np.column_stack(
                            (x, lumogen_f_red_305.absorption(x) * 10.0)
                        ),
                        emission=np.column_stack(
                            (x, lumogen_f_red_305.emission(x))
                        ),
                        quantum_yield=0.9,
                        name="dye",
                    ),
                    Absorber(0.3, name="background"),
                ],
            ),
        ),
        parent=world,
    )
    light = Node(
        name="light",
        light=Light(
            direction=functools.partial(cone, np.radians(20)),
            wavelength=ConstantWavelengthMask(555.0),
        ),
        parent=world,
    )
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return Scene(world)


def gpu_device():
    """{platform, device_kind, count} of JAX's devices. Exits unless
    they are GPUs: no rate is reported from another platform."""
    import jax

    devices = jax.devices()
    device = {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "count": len(devices),
    }
    if device["platform"] != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {device}")
    return device


def main():
    import jax

    device = gpu_device()
    print(f"device: {device}", file=sys.stderr)
    # Warm the device->host transfer path before timing anything.
    np.asarray(jax.numpy.ones((8,)))

    from pvtrace_tpu import engine

    scene = build_scene()
    np.random.seed(0)

    # Photons per timed call. The budget is a traced argument (lane
    # regeneration refills dead lanes until it is spent), so one
    # compiled program serves any budget and per-call memory is
    # constant; a large budget amortises the per-call dispatch/fetch
    # and the wavefront drain tail. Kept below 2^31 so every photon
    # id / fate counter stays inside uint32/int32.
    bundle = 2_048_000_000
    # Compile + warm up. Lane regeneration with a traced photon budget:
    # the warmup (small N) and the timed runs share one compiled program.
    engine.simulate(scene, 2_000_000, seed=1, record_every=0, dtype=np.float32)

    # Timed runs (wall clock including host-side result handling)
    from pvtrace_tpu.utils.profiling import ThroughputMeter

    meter = ThroughputMeter()
    for i in range(2):
        with meter.measure(bundle):
            engine.simulate(
                scene, bundle, seed=2 + i, record_every=0, dtype=np.float32
            )

    value = meter.rate
    print(
        json.dumps(
            {
                "metric": "lsc_photon_throughput",
                "value": round(value, 1),
                "unit": "photons/s",
                "vs_baseline": round(value / BASELINE_RAYS_PER_S, 3),
                "device": device,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
