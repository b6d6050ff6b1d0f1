"""``device_idle_pct``: the share of the traced window in which no kernel,
copy or set ran on the card, in %: one minus the union of their intervals
(``devtrace.analyse``).  A ``run`` cell reads them from ``torch.profiler``
in the harness's process; a ``cohort`` cell from every library process's
own profile, merged on the epoch, with time outside every library's
profile idle."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
