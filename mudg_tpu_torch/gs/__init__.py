"""3D Gaussian Splatting: scene, projection, rasterizers, refinement (port of `mudg_tpu/gs`)."""
