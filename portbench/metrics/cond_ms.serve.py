"""cond_ms.serve (ms): per served window, the device time of the
operations launched inside the CLIP towers, the resampler and the VAE
encoder, in the traced window."""

LAYERS = ("clip_text", "clip_image", "image_proj", "vae.encoder")


def read(s):
    dev = (s.get("trace") or {}).get("device_s")
    if s.get("kind") != "serve" or not dev:
        return None
    return 1e3 * sum(dev.get(k, 0.0) for k in LAYERS) / s["traced"]
