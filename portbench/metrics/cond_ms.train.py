"""cond_ms.train (ms): per optimizer step, the device time of the
operations launched inside the frozen VAE encoder and CLIP towers and the
resampler's forward, in the traced step."""

LAYERS = ("clip_text", "clip_image", "image_proj", "vae.encoder")


def read(s):
    dev = (s.get("trace") or {}).get("device_s")
    if s.get("kind") != "train" or not dev:
        return None
    return 1e3 * sum(dev.get(k, 0.0) for k in LAYERS) / s["traced"]
