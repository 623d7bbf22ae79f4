"""Set-up seconds: from the start of the process to the start of the
window (loading, weights, inputs, kernel builds, warm-up)."""


def read(rec):
    return rec["setup_s"]
