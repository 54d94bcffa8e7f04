"""idle_share.train: the share of the traced epochs in which no operation
ran on the card, in %."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
