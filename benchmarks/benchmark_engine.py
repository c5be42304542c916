"""Throughput benchmark: oracle tracer vs device engine.

Counterpart of the reference's benchmarks/benchmark_engine.py (LSC slab
with a Lumogen-like dye, python tracer vs compiled engine at several
thread counts). Here the comparison is oracle rays/s vs device photon
throughput at several bundle sizes, plus recorder-only mode.

Needs a GPU for the engine rates.

Run:  python benchmarks/benchmark_engine.py [--quick]
"""
import argparse
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from bench import build_scene, gpu_device  # noqa: E402


def bench_oracle(scene, n):
    from pvtrace_tpu.algorithm import photon_tracer

    np.random.seed(1)
    tic = time.perf_counter()
    for ray in scene.emit(n):
        photon_tracer.follow(scene, ray)
    return n / (time.perf_counter() - tic)


def bench_engine(scene, n, record_every=0, recorders=False):
    from pvtrace_tpu import engine
    from pvtrace_tpu.engine import Histogram, Recorder

    lsc = [node for node in scene.root.iter_preorder() if node.name == "lsc"][0]
    lsc.recorders = (
        [
            Recorder(
                "edges",
                event="escaping",
                histograms=[Histogram("wavelength", 400, 800, 100)],
            )
        ]
        if recorders
        else []
    )
    engine.simulate(scene, n, seed=1, record_every=record_every)  # warm
    tic = time.perf_counter()
    engine.simulate(scene, n, seed=2, record_every=record_every)
    return n / (time.perf_counter() - tic)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--quick", action="store_true")
    args = parser.parse_args()
    print(f"device: {gpu_device()}")

    scene = build_scene()
    n_oracle = 200 if args.quick else 1000
    rate = bench_oracle(scene, n_oracle)
    print(f"oracle tracer: {rate:,.0f} rays/s")

    for n in (100_000,) if args.quick else (1_000_000, 4_000_000):
        rate = bench_engine(build_scene(), n)
        print(f"engine, {n:,} photons: {rate:,.0f} photons/s")

    n = 100_000 if args.quick else 2_000_000
    rate = bench_engine(build_scene(), n, recorders=True)
    print(f"engine recorder-only mode, {n:,} photons: {rate:,.0f} photons/s")


if __name__ == "__main__":
    main()
