"""Device-scale gradient validation: score estimator vs CRN finite
differences at 10^7-10^8 photons (BASELINE north star: dL/d(concentration)
to 1e-3).

Three comparisons on the flagship LSC benchmark scene (5x5x1 slab,
Lumogen-like dye qy 0.9 + 0.3/cm background, cone light):

1. d P(fate) / d log(dye scale)  — score channel vs central FD with
   common random numbers, fate fractions from the fast tally path.
2. d P(fate) / d log(background scale) — same machinery, second channel.
3. d(optical efficiency) / d log(dye scale) via LSC.gradient() with
   edge solar cells, vs CRN central FD of the collected/incident ratio.

Run on a GPU:  python benchmarks/validate_gradients.py [N]
Writes a markdown table to stdout (paste into docs/VALIDATION.md).
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def lsc_scene(scale_dye=1.0, scale_bg=1.0):
    import functools

    from pvtrace_tpu import (
        Absorber, Box, Light, Luminophore, Material, Node, Scene, Sphere,
        cone, lumogen_f_red_305,
    )
    from pvtrace_tpu.light.light import ConstantWavelengthMask

    x = np.arange(400, 801, dtype=float)
    world = Node(
        name="world",
        geometry=Sphere(radius=25.0, material=Material(refractive_index=1.0)),
    )
    Node(
        name="lsc",
        parent=world,
        geometry=Box(
            (5.0, 5.0, 1.0),
            material=Material(
                refractive_index=1.5,
                components=[
                    Luminophore(
                        np.column_stack(
                            (x, scale_dye * 10.0 * lumogen_f_red_305.absorption(x))
                        ),
                        emission=np.column_stack(
                            (x, lumogen_f_red_305.emission(x))
                        ),
                        quantum_yield=0.9,
                        name="dye",
                    ),
                    Absorber(0.3 * scale_bg, name="background"),
                ],
            ),
        ),
    )
    light = Node(
        name="light",
        parent=world,
        light=Light(
            direction=functools.partial(cone, np.radians(20)),
            wavelength=ConstantWavelengthMask(555.0),
        ),
    )
    light.translate((0.0, 0.0, 3.0))
    light.rotate(np.radians(180), (1, 0, 0))
    return Scene(world)


def fate_fractions(scene, n, seed):
    from pvtrace_tpu.engine.api import simulate
    from pvtrace_tpu.light.event import Event

    res = simulate(scene, n, seed=seed, record_every=0)
    fates = np.asarray(res.data["fates"], dtype=np.float64)
    return {e: fates[e.value] / n for e in (Event.EXIT, Event.NONRADIATIVE)}


def main():
    from pvtrace_tpu.diff.transport import fate_gradients
    from pvtrace_tpu.light.event import Event

    from bench import gpu_device

    print(f"device: {gpu_device()}")
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000_000
    seed = 7
    delta = 0.05

    rows = []

    # --- fate-fraction gradients, dye + background channels ----------
    tic = time.perf_counter()
    _, grads = fate_gradients(lsc_scene(), n, seed=seed)
    t_score = time.perf_counter() - tic
    print(f"# score run: {n:.0e} photons in {t_score:.1f}s", file=sys.stderr)

    for ch, name in ((0, "dye"), (1, "background")):
        scale_kw = "scale_dye" if ch == 0 else "scale_bg"
        fp = fate_fractions(lsc_scene(**{scale_kw: np.exp(delta)}), n, seed)
        fm = fate_fractions(lsc_scene(**{scale_kw: np.exp(-delta)}), n, seed)
        for event in (Event.EXIT, Event.NONRADIATIVE):
            fd = (fp[event] - fm[event]) / (2 * delta)
            est = grads[event][ch]
            rows.append((
                f"dP({event.name})/dlog({name})", est, fd, abs(est - fd),
            ))

    # --- optical-efficiency gradient via LSC.gradient ----------------
    from pvtrace_tpu.device.lsc import LSC
    from pvtrace_tpu.data import lumogen_f_red_305

    x = np.arange(400, 801, dtype=float)

    def make(scale):
        lsc = LSC((5.0, 5.0, 1.0))
        lsc.add_luminophore(
            "dye",
            np.column_stack((x, scale * 5.0 * lumogen_f_red_305.absorption(x))),
            np.column_stack((x, lumogen_f_red_305.emission(x))),
            quantum_yield=0.9,
        )
        lsc.add_absorber("bg", 0.1)
        lsc.add_solar_cell({"left", "right", "near", "far"})
        return lsc

    n_lsc = min(n, 20_000_000)
    base = make(1.0).gradient(n=n_lsc, seed=seed, component="dye")
    hi = make(np.exp(delta)).gradient(n=n_lsc, seed=seed, component="dye")
    lo = make(np.exp(-delta)).gradient(n=n_lsc, seed=seed, component="dye")
    fd = (hi["optical_efficiency"] - lo["optical_efficiency"]) / (2 * delta)
    rows.append((
        f"d(opt. eff.)/dlog(dye) @ {n_lsc:.0e}",
        base["gradient"], fd, abs(base["gradient"] - fd),
    ))

    print(f"| Gradient (N = {n:.0e}, CRN central FD, delta = {delta}) "
          "| score | FD | |score - FD| |")
    print("|---|---|---|---|")
    for label, est, fd, err in rows:
        flag = "" if err <= 1e-3 else "  **> 1e-3**"
        print(f"| {label} | {est:+.5f} | {fd:+.5f} | {err:.1e}{flag} |")
    worst = max(r[3] for r in rows)
    print(f"\nworst |score - FD| = {worst:.2e} "
          f"({'PASS' if worst <= 1e-3 else 'FAIL'} vs 1e-3 target)")


if __name__ == "__main__":
    main()
