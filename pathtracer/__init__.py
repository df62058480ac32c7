"""pathtracer — a physically-based wavefront path tracer in JAX.

Built from scratch in JAX / XLA / Pallas with the capabilities of the OptiX
thesis renderer ``safardani/szakdolgozat-pathtracer`` (see SURVEY.md):

* OBJ/MTL scene loading with the full PBR texture set
  (albedo / roughness / metallic / normal),
* GGX microfacet + Lambertian BSDF with importance sampling,
* dielectric glass, HDR equirectangular environment lighting,
* thin-lens depth of field, Russian roulette, progressive accumulation,
* filmic (ACES-fit) tonemapping post chain.

Where the reference is a single-GPU OptiX *megakernel* (one CUDA thread per
pixel, hardware BVH + shader-execution-reordering), this framework is a
*wavefront* design: a divergence-free masked bounce loop over SoA ray
buffers compiled by XLA, software Morton cluster-packet traversal (a
Pallas/Triton kernel on NVIDIA GPUs), counter-based per-lane RNG for
bitwise-reproducible renders, and `shard_map` sample/tile sharding with
collective accumulation across devices.
"""

from pathtracer.config import RenderConfig
from pathtracer.render.camera import Camera
from pathtracer.scene.scene import Scene, MaterialTable, EnvironmentMap

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "Camera",
    "Scene",
    "MaterialTable",
    "EnvironmentMap",
    "__version__",
]
