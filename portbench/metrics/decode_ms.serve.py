"""decode_ms.serve (ms): per served window, the device time of the
operations launched inside the VAE decoder, in the traced window."""


def read(s):
    dev = (s.get("trace") or {}).get("device_s")
    if s.get("kind") != "serve" or not dev or "vae.decoder" not in dev:
        return None
    return 1e3 * dev["vae.decoder"] / s["traced"]
