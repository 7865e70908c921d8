"""MuDG in PyTorch with hand-written CUDA kernels for Hopper (H100).

Port of the JAX package `mudg_tpu`, which stays the reference. Module paths
mirror it:
    core/          schedules, CFG combiners, the VAE posterior
    nn/            functional layers, attention, the 3D UNet, the VAE
    kernels/       CUDA kernels (sources in csrc/) with their plain versions
    diffusion/     DDIM and DPM-Solver++ sampling
    models/        the MDM: conditioning, sample / sample_clip, training_loss
    train/         the training step: AdamW, clipping, accumulation, EMA
    convert.py     JAX parameter trees -> the port's modules
This package imports torch and never jax.
"""

__version__ = "0.1.0"
