"""toyrenderer_tpu_torch -- the PyTorch / CUDA port of the
toyrenderer_tpu package.

Renders the reference package's deferred visibility-buffer frame (with
culling, RT sun shadows and the post chain) on an NVIDIA GPU.  Plain
tensor code is PyTorch; each TPU Pallas kernel on that path is a
hand-written CUDA kernel (csrc/: fill+resolve, peel fill, BVH
traversal, reprojection warp) with a plain PyTorch twin that runs for
CPU tensors.  The package imports nothing of the JAX package: what it
needs from there it keeps as its own copy.

Layout mirrors the reference package:
  scene/    glTF + meshopt decode, meshlets, LODs, PNG textures, buffers
  native/   g++-built host builders (meshopt, meshlets, simplifier)
  mathlib/  matrices, quaternions, jitter
  ops/      geometry, raster, culling, gbuffer, shading, RT tree and
            shadows, denoise, post; each kernel's wrapper (*_cuda.py)
  engine/   View, RenderSettings, render_frame
  parallel/ a device Mesh; one frame's raster sharded by tile rows
            (each band a K1 fill on its device), its rays in slices,
            a batch of views over ('dp', 'sp')
  tools/    the render CLI, the HTTP viewer (shell), the benches
            (rtbench, fillbench, passes), the scene generator
  csrc/     CUDA sources, built by nvcc at first use into build/
"""

# first, before any module of the port computes: warms the CPU's vector
# math so that its first frame-sized call is correctly rounded
from toyrenderer_tpu_torch.mathlib import precise  # noqa: E402,F401
