"""The share of the window in which no operation ran on the device."""


def read(rec):
    w = rec["window"]
    if not w.traced:
        return None
    return 100.0 * (1.0 - w.busy_s() / w.seconds)
