"""``screen_roofline_pct``: the split-read screen's least time on the card
(its DP cells from the candidates' shapes at ``roofline.CELL_OPS`` a cell
over the card's integer peak) over ``screen_kernel``'s device time in the
traced window, in %.  Nothing when the screen did not run on the card,
or ran in another process (a ``cohort`` cell: its cells and the card's
peak are not read there)."""

import roofline


def read(ctx):
    if ctx.trace is None or not ctx.peak_ops or not ctx.screen.cells:
        return None
    kernel_s = sum(s for n, s in ctx.trace.kernels.items()
                   if "screen_kernel" in n)
    if kernel_s <= 0:
        return None
    return roofline.share_pct(ctx.screen.cells, kernel_s, ctx.peak_ops)
