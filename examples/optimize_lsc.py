"""Inverse design demo: tune the dye concentration of an LSC so a
target fraction of photons is absorbed, using the UNBIASED multi-bounce
score-function gradient (the straight-line surrogate in
`diff.transport.make_training_step` is biased once the n=1.5 surface
bends rays; this demo uses the full estimator instead).

Run (GPU or CPU):  python examples/optimize_lsc.py
"""
import functools

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
    cone,
    lumogen_f_red_305,
)
from pvtrace_tpu.diff.transport import optimize_concentration
from pvtrace_tpu.light.event import Event
from pvtrace_tpu.light.light import ConstantWavelengthMask


def build(scale):
    # `scale` multiplies the BACKGROUND absorber: the loss fraction
    # responds strongly to it (dP/dlog ~ +0.17), so a target is
    # reachable in a few steps. (Scaling the dye instead barely moves
    # the fates here: re-absorbed photons mostly re-emit at qy=0.9, so
    # dP/dlog(dye) ~ -0.013 — a deliberately weak lever.)
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
                            (x, 10.0 * lumogen_f_red_305.absorption(x))
                        ),
                        emission=np.column_stack(
                            (x, lumogen_f_red_305.emission(x))
                        ),
                        quantum_yield=0.9,
                        name="dye",
                    ),
                    Absorber(0.3 * scale, name="background"),
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


def main():
    target = 0.55  # want 55% of photons lost in the plate
    log_scale, history = optimize_concentration(
        build, target, num_rays=400_000, iters=6, lr=8.0, seed=11,
        component=1, event=Event.NONRADIATIVE, verbose=True,
    )
    print(f"\noptimal background scale ~ {np.exp(log_scale):.3f} "
          f"(log scale {log_scale:+.4f})")
    print("history (log_scale, P, loss):")
    for row in history:
        print("  %+0.4f  %.4f  %.6f" % row)


if __name__ == "__main__":
    main()
