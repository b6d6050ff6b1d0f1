"""``device_idle_pct``: the share of the traced window in which no kernel,
copy or set ran on the card (one minus the union of their intervals from
``torch.profiler``), in %."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
