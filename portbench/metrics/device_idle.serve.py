"""device_idle.serve (%): the share of a served window in which no
operation ran on the card: the traced window's busy time (the union of its
device operations) over the untraced span's wall time a window, since the
profiler's host cost stretches the traced window itself."""


def read(s):
    tr = s.get("trace") or {}
    if s.get("kind") != "serve" or not tr.get("ops"):
        return None
    return 100.0 * (1.0 - (tr["busy_s"] / s["traced"]) / (s["span_s"] / s["windows"]))
