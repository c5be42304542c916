"""Recorder-axis scaling: compile time and step cost vs recorder count.

The reference engine caps recorders at 256 (compiler MAX_RECORDERS,
reference engine/compiler.py:23). The device tracer's tally is
vectorized over the recorder axis ([B, R] match matrix + matmuls),
so both program size and per-step cost should stay ~flat as R grows;
this benchmark records the evidence. Needs a GPU.

Run:  python benchmarks/benchmark_recorders.py [n_photons]
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")
from bench import build_scene, gpu_device  # noqa: E402


def scene_with_recorders(n_rec):
    from pvtrace_tpu.engine.recorder import Histogram, Recorder

    scene = build_scene()
    lsc = next(n for n in scene.root.iter_preorder() if n.name == "lsc")
    events = ["escaping", "entering", "reflected", "lost"]
    faces = [
        (0, 0, 1), (0, 0, -1), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
    ]
    recs = []
    for i in range(n_rec):
        event = events[i % len(events)]
        rec = Recorder(
            f"r{i:03d}",
            event=event,
            facet=faces[i % len(faces)] if event != "lost" else None,
            histograms=[Histogram("wavelength", 400.0, 800.0, 50)],
        )
        recs.append(rec)
    lsc.recorders = recs
    return scene


def main():
    from pvtrace_tpu import engine

    print(f"device: {gpu_device()}")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4_000_000
    repeats = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    print("| recorders | compile (s) | best of "
          f"{repeats} (s) | photons/s |")
    print("|---|---|---|---|")
    for n_rec in (0, 4, 32, 128, 256):
        scene = scene_with_recorders(n_rec)
        tic = time.perf_counter()
        engine.simulate(scene, 2_000_000, seed=1, record_every=0)
        compile_s = time.perf_counter() - tic
        # Best-of-N: single shots mix dispatch/fetch hiccups into the
        # measurement.
        best = float("inf")
        for i in range(repeats):
            tic = time.perf_counter()
            res = engine.simulate(scene, n, seed=2 + i, record_every=0)
            best = min(best, time.perf_counter() - tic)
        print(
            f"| {n_rec} | {compile_s:.1f} | {best:.2f} | {n / best:,.0f} |"
        )
        assert sum(r.rays for r in res.recorders.values()) >= 0


if __name__ == "__main__":
    main()
