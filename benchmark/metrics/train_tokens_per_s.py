"""Positions through the encoder blocks a second: every step of the window
over the window's whole length (host clock, the device synchronised at
both ends)."""


def read(rec):
    w = rec["window"]
    return rec["tokens"] / w.seconds if w.seconds > 0 else None
