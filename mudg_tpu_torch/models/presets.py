"""Named model presets: the published two stages and a tiny test config
(port of `mudg_tpu/models/presets.py`)."""
from __future__ import annotations

from . import mdm as M
from ..conditioning import clip as CL
from ..nn import resampler as R
from ..nn import unet3d as U
from ..nn import vae as V


def mdm512() -> M.MDMConfig:
    """Stage-1 320x512 model (configs/stage1-512_mdm_waymo/config.yaml)."""
    return M.MDMConfig(base_scale=0.7)


def mdm1024() -> M.MDMConfig:
    """Stage-2 576x1024 model (configs/stage2-1024_mdm_waymo/config.yaml)."""
    return M.stage2_config()


def tiny() -> M.MDMConfig:
    """Minutes-not-hours config for smoke tests and CI."""
    return M.MDMConfig(
        unet=U.UNetConfig(
            in_channels=12, out_channels=4, model_channels=32, num_res_blocks=1,
            attention_resolutions=(1,), channel_mult=(1, 2), num_head_channels=16,
            context_dim=16, temporal_length=4, image_tokens_per_frame=2,
        ),
        vae=V.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        resampler=R.ResamplerConfig(
            dim=16, depth=1, dim_head=8, heads=2, num_queries=2,
            embedding_dim=24, output_dim=16, video_length=4,
        ),
        clip_text=CL.TextConfig(vocab_size=49408, width=16, heads=2, layers=2,
                                context_length=77),
        clip_image=CL.VisionConfig(image_size=224, patch_size=112, width=24,
                                   heads=2, layers=1),
        vae_chunk=0,
    )
