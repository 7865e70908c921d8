"""device_idle.train (%): the share of an optimizer step in which no
operation ran on the card: the traced step's busy time over the untraced
span's wall time a step."""


def read(s):
    tr = s.get("trace") or {}
    if s.get("kind") != "train" or not tr.get("ops"):
        return None
    return 100.0 * (1.0 - (tr["busy_s"] / s["traced"]) / (s["span_s"] / s["steps"]))
