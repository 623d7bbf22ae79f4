"""Device milliseconds a step in the optimizer's multi-tensor kernels (the
"optimizer (foreach)" group of the trace)."""


def read(rec):
    w = rec["window"]
    if not w.traced or not rec["steps"]:
        return None
    spent = w.group_s().get("optimizer (foreach)")
    return None if spent is None else 1e3 * spent / rec["steps"]
