"""Worker for tests/test_multihost.py: one JAX process of a 2-process run.

Usage: python multihost_worker.py <process_id> <num_processes> <port> <out.json>

Joins the distributed runtime, traces the shared test scene over the
GLOBAL device mesh (device-side emission + regeneration), and writes
its view of the psum-reduced tallies as JSON. Every process must see
identical (replicated) tallies, and they must be bitwise equal to a
single-process run over the same global mesh size — per-photon RNG
streams depend only on (seed, global photon id).
"""
import json
import sys


def build_scene():
    import numpy as np

    from pvtrace_tpu import (
        Absorber,
        Box,
        Light,
        Luminophore,
        Material,
        Node,
        Scene,
        Sphere,
    )
    from pvtrace_tpu.data import lumogen_f_red_305
    from pvtrace_tpu.light.light import ConstantWavelengthMask

    x = np.arange(400, 801, dtype=float)
    world = Node(
        name="world",
        geometry=Sphere(radius=10.0, material=Material(refractive_index=1.0)),
    )
    Node(
        name="lsc",
        geometry=Box(
            (5.0, 5.0, 1.0),
            material=Material(
                refractive_index=1.5,
                components=[
                    Luminophore(
                        coefficient=np.column_stack(
                            (x, lumogen_f_red_305.absorption(x) * 5.0)
                        ),
                        emission=np.column_stack(
                            (x, lumogen_f_red_305.emission(x))
                        ),
                        quantum_yield=0.8,
                        name="dye",
                    ),
                    Absorber(0.2, name="bg"),
                ],
            ),
        ),
        parent=world,
    )
    light = Node(
        name="light",
        light=Light(wavelength=ConstantWavelengthMask(555.0)),
        parent=world,
    )
    light.translate((0.0, 0.0, 2.0))
    light.rotate(3.141592653589793, (1, 0, 0))
    return Scene(world)


def trace_global_mesh(n_rays, seed, lanes):
    """Trace over the global mesh; returns tallies as plain lists.

    Two passes: the tallies-only fast path, then a cfg.score pass with
    a pathwise ("n", lsc) channel — the unbiased gradient estimator's
    fate_scores must all-reduce across PROCESSES exactly like the
    counters (SURVEY §2.3 "gradient all-reduce for the differentiable
    path").
    """
    import jax
    import numpy as np

    from pvtrace_tpu.diff.transport import resolve_pathwise_params
    from pvtrace_tpu.engine import compiler as comp
    from pvtrace_tpu.engine import tracer as tracer_module
    from pvtrace_tpu.parallel import global_photon_mesh, shard_trace_device_emit

    mesh = global_photon_mesh()
    scene = build_scene()
    compiled = comp.compile_scene(scene)
    cfg = tracer_module.make_config(
        compiled, n_rays=n_rays, dtype=np.float32, record_every=0
    )
    tables = compiled.device_tables(np.float32)
    traced = shard_trace_device_emit(compiled, cfg, mesh, lanes=lanes)
    tallies, _steps = traced(tables, n_rays, jax.random.PRNGKey(seed))
    jax.block_until_ready(tallies)

    score_cfg = tracer_module.make_config(
        compiled, n_rays=n_rays, dtype=np.float32, record_every=0,
        score=True, pathwise=resolve_pathwise_params(compiled, [("n", "lsc")]),
    )
    score_traced = shard_trace_device_emit(
        compiled, score_cfg, mesh, lanes=lanes
    )
    score_tallies, _ = score_traced(tables, n_rays, jax.random.PRNGKey(seed))
    jax.block_until_ready(score_tallies)
    return {
        "n_devices": len(jax.devices()),
        "n_processes": jax.process_count(),
        "fates": np.asarray(tallies["fates"]).tolist(),
        "distinct": np.asarray(tallies["distinct"]).tolist(),
        "cross": np.asarray(tallies["cross"]).tolist(),
        "bins": np.asarray(tallies["bins"]).tolist(),
        "sums": np.asarray(tallies["sums"]).tolist(),
        "score_fates": np.asarray(score_tallies["fates"]).tolist(),
        "fate_scores": np.asarray(score_tallies["fate_scores"]).tolist(),
    }


def main():
    process_id, num_processes, port = (int(a) for a in sys.argv[1:4])
    out_path = sys.argv[4]

    from pvtrace_tpu.parallel import init_distributed

    init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    result = trace_global_mesh(n_rays=4096, seed=11, lanes=256)
    with open(out_path, "w") as fh:
        json.dump(result, fh)


if __name__ == "__main__":
    main()
