"""unet_ms.serve (ms): the device time of one UNet forward, from the
operations launched inside the UNet's calls."""


def read(s):
    tr = s.get("trace") or {}
    n = tr.get("ranges", {}).get("unet")
    if s.get("kind") != "serve" or not n or "unet" not in tr.get("device_s", {}):
        return None
    return 1e3 * tr["device_s"]["unet"] / n
