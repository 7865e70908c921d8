"""Faults planted in the program for the check to catch: the CPU tests run
each at the tiny size, and `calibrate.py --fault` reads the training ones on
the card at the cell's size. Each `plant_*` patches the port in this process
and returns the function that undoes it; the benchmark's runs plant none.
"""
from __future__ import annotations


def _patch(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    return lambda: setattr(obj, name, old)


def plant_state_unchanged_sampler():
    """Each DDIM step returns its state unchanged."""
    from mudg_tpu_torch.diffusion import ddim

    return _patch(ddim, "ddim_step", lambda x, v, const, noise, **kw: (x, x))


def plant_half_batch_unet():
    """The UNet computes the first half of its batch; the rest is that
    half's mean."""
    import torch

    from mudg_tpu_torch.nn import unet3d as U

    orig = U.UNet3D.forward

    def forward(self, x, *a, **kw):
        out = orig(self, x, *a, **kw)
        half = out.shape[0] // 2
        return torch.cat([out[:half], out[:half].mean(0, keepdim=True).expand_as(out[half:])])

    return _patch(U.UNet3D, "forward", forward)


def plant_slot_altered():
    """The UNet's prediction for the last row of its batch (one task's
    conditional variant) comes out halved."""
    from mudg_tpu_torch.nn import unet3d as U

    orig = U.UNet3D.forward

    def forward(self, x, *a, **kw):
        out = orig(self, x, *a, **kw).clone()
        out[-1] = out[-1] * 0.5
        return out

    return _patch(U.UNet3D, "forward", forward)


def plant_frame_altered():
    """The decoder's first frame of each clip comes out negated."""
    from mudg_tpu_torch.nn import vae as V

    orig = V.decode_video

    def decode(vae, z, chunk=1):
        x = orig(vae, z, chunk)
        x[:, 0] = -x[:, 0]
        return x

    return _patch(V, "decode_video", decode)


def plant_state_unchanged_train():
    """The optimizer leaves the parameters and its state unchanged."""
    from mudg_tpu_torch.train import step as TS

    return _patch(TS.AdamW, "update", lambda self, state, grads, gnorm, views=None: None)


def plant_half_batch_train():
    """The loss of a micro-batch is the mean over its first half alone."""
    from mudg_tpu_torch.models import mdm as M

    orig = M.training_loss

    def loss(mdm, batch, draws, **kw):
        half = batch["dense_frames"].shape[0] // 2
        cut = {k: v[:half] for k, v in batch.items()}
        d = {k: (v.reshape(3, -1, *v.shape[1:])[:, :half].reshape(-1, *v.shape[1:])
                 if k == "posterior_eps" else v[:half]) for k, v in draws.items()}
        return orig(mdm, cut, d, **kw)

    return _patch(M, "training_loss", loss)


SERVE = {"state_unchanged": plant_state_unchanged_sampler,
         "half_batch_mean": plant_half_batch_unet, "slot_altered": plant_slot_altered,
         "answer_altered": plant_frame_altered}
TRAIN = {"state_unchanged": plant_state_unchanged_train,
         "half_batch_mean": plant_half_batch_train}
