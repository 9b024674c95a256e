"""Progressive Monte Carlo path tracer in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
PrimozLavric/LogiPathTracer (C++17 / Vulkan / GLSL): a progressive,
unidirectional path tracer for glTF 2.0 scenes with a two-level BVH,
Heitz multiple-scattering microfacet BSDFs, and interactive progressive
accumulation.  The reference's two GPU backends (compute megakernel +
RTX pipeline) collapse here into one jitted renderer (lockstep
megakernel, or a pooled wavefront), with BVH traversal in a CUDA kernel
on the GPU; the Vulkan host runtime is replaced by the XLA runtime +
jit.

Reference layer map: see SURVEY.md.
"""

from logipathtracer_tpu.config import RenderConfig
from logipathtracer_tpu.scene.gltf import load_gltf
from logipathtracer_tpu.scene.compile import compile_scene


def __getattr__(name):
    # Lazy: the renderers import jax-heavy modules.
    if name == "ProgressiveRenderer":
        from logipathtracer_tpu.render.progressive import ProgressiveRenderer
        return ProgressiveRenderer
    if name == "MeshRenderer":
        from logipathtracer_tpu.parallel.mesh import MeshRenderer
        return MeshRenderer
    if name == "render_wavefront":
        from logipathtracer_tpu.render.wavefront import render_wavefront
        return render_wavefront
    if name == "render_sample":
        from logipathtracer_tpu.render.megakernel import render_sample
        return render_sample
    raise AttributeError(name)


__version__ = "0.1.0"

__all__ = ["RenderConfig", "load_gltf", "compile_scene",
           "ProgressiveRenderer", "MeshRenderer", "render_wavefront",
           "render_sample", "__version__"]
