"""The flash attention kernels (#5 forward, #6 backward): the least time
of the window's calls (operations at the bf16 peak or bytes once at the
HBM peak, counted from the shapes, a rematerialised forward twice) over
their time in the trace; nothing where the program did not launch the
forwards counted."""


def read(rec):
    w = rec["window"]
    if not w.traced:
        return None
    g = w.group_s()
    spent = g.get("flash_attention", 0.0) + g.get("flash_attention_bwd", 0.0)
    least = rec["attn_least_s"]["flash"]
    if spent <= 0 or not least:
        return None
    return 100.0 * least / spent
