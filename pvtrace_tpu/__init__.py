"""pvtrace_tpu — Monte Carlo photon transport on an accelerator.

A from-scratch JAX/XLA re-design of the capabilities of pvtrace
(https://github.com/danieljfarrell/pvtrace): statistical photon path
tracing for luminescent solar concentrators and non-imaging optics.

Architecture: the Python scene API (Node/Scene/Material/Light) mirrors
the reference so scenes, tests and YAML specs carry over, but execution
is compiler-first — scenes lower to flat device tables
(``pvtrace_tpu.engine.compiler``) traced by a vectorised wavefront
kernel (``pvtrace_tpu.engine.tracer``) running under ``jax.jit``, with
photon batches sharded over device meshes (``pvtrace_tpu.parallel``).
A per-ray numpy oracle (``pvtrace_tpu.algorithm.photon_tracer``)
provides the validation reference and a fallback for scenes outside the
compiled subset.
"""
__version__ = "0.1.0"

import logging

logger = logging.getLogger("pvtrace_tpu")

# algorithm
from pvtrace_tpu.algorithm import photon_tracer

# data
from pvtrace_tpu.data import lumogen_f_red_305, fluro_red

# geometry
from pvtrace_tpu.geometry.box import Box
from pvtrace_tpu.geometry.cylinder import Cylinder
from pvtrace_tpu.geometry.mesh import Mesh
from pvtrace_tpu.geometry.sphere import Sphere

# light
from pvtrace_tpu.light.light import (
    Light,
    rectangular_mask,
    circular_mask,
    cube_mask,
)
from pvtrace_tpu.light.ray import Ray
from pvtrace_tpu.light.event import Event

# material
from pvtrace_tpu.material.component import Scatterer, Absorber, Luminophore, Reactor
from pvtrace_tpu.material.distribution import Distribution
from pvtrace_tpu.material.material import Material
from pvtrace_tpu.material.surface import (
    Surface,
    SurfaceDelegate,
    NullSurfaceDelegate,
    FresnelSurfaceDelegate,
)
from pvtrace_tpu.material.utils import isotropic, henyey_greenstein, cone

# scene
from pvtrace_tpu.scene.node import Node
from pvtrace_tpu.scene.scene import Scene


def __getattr__(name):
    # Lazy imports that pull in heavier optional machinery.
    if name == "LSC":
        from pvtrace_tpu.device.lsc import LSC

        return LSC
    if name == "MeshcatRenderer":
        from pvtrace_tpu.scene.renderer import MeshcatRenderer

        return MeshcatRenderer
    raise AttributeError(f"module 'pvtrace_tpu' has no attribute {name!r}")
