"""vae_host_ms.serve (ms): per served window, the host-clock time inside
the program's `vae.encode` and `vae.decode` spans (one a frame), from
the span totals of the untraced span."""

NAMES = ("vae.encode", "vae.decode")


def read(s):
    sp = s.get("spans")
    if s.get("kind") != "serve" or not sp or not sp.get("windows"):
        return None
    ns = sum(t["ns"] for path, t in sp["totals"].items() if path.rsplit("/", 1)[-1] in NAMES)
    return 1e-6 * ns / sp["windows"] if ns else None
