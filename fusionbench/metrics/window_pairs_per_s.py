"""``window_pairs_per_s``: the read pairs of the libraries that finished in
the window over the time from the window's start to the last one's end
(the harness's clock): the work a group buys per second at a stated
library size.  It follows the host's speed, which drifts by a fifth and
more over a minute on the machine that carries the card (``PERF.md``), so
it is read per layer, in traced runs, and holds no bound."""


def read(ctx):
    libs = ctx.libraries
    if not libs or not ctx.seconds:
        return None
    return sum(r["pairs"] for r in libs) / ctx.seconds
