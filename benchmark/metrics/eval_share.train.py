"""eval_share.train: host-clock seconds of the evals (each ending in its
read-back of the F1s) over the traced window, in %."""


def read(ctx):
    f = ctx["facts"]
    return 100.0 * f["eval_s"] / f["seconds"]
