"""Photon-throughput scaling over a device mesh (BASELINE 1->N metric).

Weak scaling: each mesh size traces a FIXED per-device photon budget
through `shard_trace_device_emit` (device-side emission + lane
regeneration, tallies psum-reduced), so ideal scaling is constant time
and efficiency(N) = time(1) / time(N).

Run it on a machine with several GPUs (and under
`parallel.init_distributed()` for multi-host — the entry points are
identical). It refuses other platforms: virtual CPU devices share the
host's cores and measure no scaling.

Usage: python benchmarks/benchmark_scaling.py [per_device_photons]
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(per_device=200_000):
    import jax

    from bench import build_scene, gpu_device
    from pvtrace_tpu.engine import compiler as comp
    from pvtrace_tpu.engine import tracer as tracer_module
    from pvtrace_tpu.parallel import make_photon_mesh, shard_trace_device_emit

    device = gpu_device()
    devices = jax.devices()
    scene = build_scene()
    compiled = comp.compile_scene(scene)
    tables = compiled.device_tables(np.float32)
    key = jax.random.PRNGKey(3)

    sizes = [n for n in (1, 2, 4, 8) if n <= len(devices)]
    rows = []
    for n in sizes:
        mesh = make_photon_mesh(devices[:n])
        budget = per_device * n
        cfg = tracer_module.make_config(
            compiled, n_rays=budget, dtype=np.float32, record_every=0
        )
        traced = shard_trace_device_emit(
            compiled, cfg, mesh, lanes=min(per_device, 1 << 16)
        )
        tallies, _ = traced(tables, budget, key)  # compile + warm
        jax.block_until_ready(tallies)
        timed_key = jax.random.PRNGKey(17)  # fresh inputs for the timed run
        tic = time.perf_counter()
        tallies, _ = traced(tables, budget, timed_key)
        jax.block_until_ready(tallies)
        dt = time.perf_counter() - tic
        assert int(np.asarray(tallies["fates"]).sum()) == budget
        rows.append({"devices": n, "photons": budget, "seconds": dt,
                     "photons_per_s": budget / dt})

    t1 = rows[0]["seconds"]
    for row in rows:
        row["weak_scaling_efficiency"] = t1 / row["seconds"]
        print(
            f"{row['devices']} device(s): {row['photons']:>9,} photons "
            f"in {row['seconds']:6.3f}s = {row['photons_per_s']/1e6:6.2f}M/s"
            f"  efficiency {row['weak_scaling_efficiency']:.2f}"
        )
    print(json.dumps({"mode": "weak-scaling", "device": device,
                      "rows": rows}))


if __name__ == "__main__":
    per_device = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    main(per_device)
