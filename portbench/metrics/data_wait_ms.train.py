"""data_wait_ms.train (ms): per optimizer step, the host's wait on the
`BatchLoader` for the step's batch."""


def read(s):
    if s.get("kind") != "train":
        return None
    return 1e3 * s["data_wait_s"] / s["steps"]
