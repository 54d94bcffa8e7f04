"""idle_share.serve: the share of the traced requests in which no operation
ran on the card, in %."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
