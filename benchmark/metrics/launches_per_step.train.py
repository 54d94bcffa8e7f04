"""launches_per_step.train: device kernels in the traced epochs (train
and eval; copies and fills left out) over the train steps in them."""

NOT_KERNELS = ("Memcpy", "Memset")


def read(ctx):
    steps = ctx["facts"]["steps"]
    if not steps:
        return None
    n = sum(cnt for name, (cnt, _) in ctx["trace"].kernels.items()
            if not name.startswith(NOT_KERNELS))
    return n / steps
