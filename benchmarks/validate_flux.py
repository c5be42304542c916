"""10^8-photon FULLSPECTRUM validation on the GPU (BASELINE north star).

Reproduces the cross-code comparison (Bose thesis sample, Fluro Red,
4.8 x 1.8 x 0.260 cm) at 10^8 photons — enough statistics to pin fate
fractions to ~0.01% MC error — and prints per-facet exit fractions next
to the published values from ICL Raytrace / ICL 3D Flux / ECN Raytrace
(reference examples/Validation.ipynb "The Sample" cell; BASELINE.md).

The reference's Python tracer needs ~20 min for 4,000 photons; the
device engine traces 10^8 in one call. The engine run needs a GPU.

Usage:
    python benchmarks/validate_flux.py [N]          # engine run
    python benchmarks/validate_flux.py --oracle N   # f64 oracle run
                                                    # (same scene, same
                                                    # recorder taxonomy)

The oracle mode exists to separate ENGINE error from CONFIGURATION
error: engine-vs-oracle per-face z-tests on the identical scene pin the
device tracer; the remaining delta to the published tracers is then a
configuration question (see docs/VALIDATION.md).
"""
import json
import multiprocessing
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pvtrace_tpu import Distribution, engine, fluro_red
from pvtrace_tpu.device.lsc import LSC
from pvtrace_tpu.engine.recorder import Recorder
from pvtrace_tpu.light.light import RectangularMask, SpectrumWavelengthMask


def lamp_spectrum(x):
    def g(x, a, p, w):
        return a * np.exp(-(((p - x) / w) ** 2))

    return g(x, 0.53025700136646192, 512.91400020614333, 93.491838802960473) + g(
        x, 0.63578999789955015, 577.63100003089369, 66.031706473985736
    )


def build():
    x = np.arange(400, 801, dtype=float)
    # 0.260 cm thick — the notebook's "The Sample" cell. (An earlier
    # revision used 0.250 here; that 4% thickness deficit shifted ~1.4
    # points of flux from the edges/top/losses to direct bottom
    # transmission and accounted for most of the systematic gap to the
    # published tracers. See docs/VALIDATION.md.)
    size = (l, w, d) = (4.8, 1.8, 0.260)
    lsc = LSC(size, wavelength_range=x)
    lsc.add_luminophore(
        "Fluro Red",
        np.column_stack((x, fluro_red.absorption(x) * 11.387815)),
        np.column_stack((x, fluro_red.emission(x))),
        quantum_yield=0.95,
    )
    lsc.add_absorber("PMMA", 0.02)
    lamp = Distribution(x, lamp_spectrum(x))
    lsc.add_light(
        "Oriel Lamp + Filter",
        (0.0, 0.0, 0.5 * d + 0.01),
        rotation=(np.radians(180), (1, 0, 0)),
        wavelength=SpectrumWavelengthMask(lamp),
        position=RectangularMask(l / 2, w / 2),
    )
    lsc._make_scene()
    scene = lsc._scene
    box = next(
        node for node in scene.root.iter_preorder() if node.name == "LSC"
    )
    facets = {
        "left": (-1, 0, 0), "right": (1, 0, 0),
        "near": (0, -1, 0), "far": (0, 1, 0),
        "top": (0, 0, 1), "bottom": (0, 0, -1),
    }
    box.recorders = [
        Recorder(name, event="escaping", facet=f) for name, f in facets.items()
    ] + [
        # Published codes report flux LEAVING the top face, which
        # includes lamp light reflected off the outside surface; our
        # recorder taxonomy separates "reflected" from "escaping".
        Recorder("top-reflected", event="reflected", facet=(0, 0, 1)),
        Recorder("lost", event="lost"),
    ]
    return scene


def _oracle_worker(args):
    """One process's share of the f64 oracle run.

    Re-builds the scene locally (scene graphs are cheaper to rebuild
    than to pickle), traces its photon share with the per-ray oracle
    tracer, and tallies with the SAME recorder taxonomy the engine
    uses (`tally_histories`), in chunks to bound memory.
    """
    seed, count = args
    from pvtrace_tpu.algorithm import photon_tracer
    from pvtrace_tpu.engine.tally import tally_histories

    scene = build()
    np.random.seed(seed)
    totals = {}
    chunk = []
    emitted = 0

    def flush():
        for name, rec in tally_histories(scene, chunk).items():
            totals[name] = totals.get(name, 0) + rec.rays
        chunk.clear()

    for ray in scene.emit(count):
        chunk.append(
            list(
                photon_tracer.step_forward(
                    scene, ray, emit_method="redshift"
                )
            )
        )
        emitted += 1
        if len(chunk) >= 2000:
            flush()
    if chunk:
        flush()
    return totals, emitted


def oracle_run(n=1_000_000, workers=None):
    """Per-face fractions from the float64 per-ray oracle tracer."""
    workers = workers or multiprocessing.cpu_count()
    share = [(1000 + i, n // workers) for i in range(workers)]
    share[-1] = (share[-1][0], n - (n // workers) * (workers - 1))
    tic = time.perf_counter()
    # Spawned workers: none inherits this process's device context.
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        parts = pool.map(_oracle_worker, share)
    dt = time.perf_counter() - tic
    totals = {}
    traced = 0
    for part, emitted in parts:
        traced += emitted
        for name, rays in part.items():
            totals[name] = totals.get(name, 0) + rays
    out = {name: rays / traced for name, rays in totals.items()}
    out["top"] = out.get("top", 0.0) + out.get("top-reflected", 0.0)
    print(f"oracle: {traced:,} photons in {dt:.0f}s "
          f"({traced/dt:.0f} rays/s, {workers} workers)")
    print(json.dumps({"mode": "oracle", "photons": traced,
                      "seconds": dt, **out}))
    return out


def main(n=100_000_000):
    from bench import gpu_device

    print(f"device: {gpu_device()}")
    scene = build()
    engine.simulate(scene, 2_000_000, seed=1, record_every=0,
                    emit_method="redshift", dtype=np.float32)
    tic = time.perf_counter()
    result = engine.simulate(scene, n, seed=7, record_every=0,
                             emit_method="redshift", dtype=np.float32)
    dt = time.perf_counter() - tic

    rec = result.recorders
    out = {name: rec[name].rays / n for name in
           ("left", "right", "near", "far", "top", "bottom",
            "top-reflected", "lost")}
    out["top"] += out["top-reflected"]  # published = flux leaving the face
    edge = out["left"] + out["right"] + out["near"] + out["far"]
    escape = out["top"] + out["bottom"]
    sigma = np.sqrt(0.25 / n)  # worst-case binomial MC error

    published = {  # Validation.ipynb cell 12: ICL Raytrace / 3D Flux / ECN
        "bottom": (0.49227, 0.49900, 0.49739),
        "top": (0.13566, 0.13807, 0.1360),
        "near": (0.07287, 0.07097, 0.07166),
        "left": (0.06638, 0.05768, 0.06365),
    }
    print(f"{n:,} photons in {dt:.2f}s = {n/dt/1e6:.1f}M photons/s "
          f"(MC error +-{sigma:.2e})")
    for face, refs in published.items():
        print(f"  {face:7s} {out[face]*100:7.3f}%   published: "
              + " / ".join(f"{r*100:.3f}%" for r in refs))
    print(f"  edge    {edge*100:7.3f}%   expected 25 +- 4 %")
    print(f"  escape  {escape*100:7.3f}%   expected 64 +- 4 %")
    print(f"  lost    {out['lost']*100:7.3f}%   expected 11 +- 4 %")
    print(json.dumps({"edge": edge, "escape": escape, "lost": out["lost"],
                      **out, "photons": n, "seconds": dt}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--oracle":
        n = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000_000
        oracle_run(n)
        sys.exit(0)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000_000
    sys.exit(main(n))
