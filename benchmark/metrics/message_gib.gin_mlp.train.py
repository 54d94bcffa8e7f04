"""message_gib.gin_mlp.train: GiB of (E, F) message matrices the traced
epochs write (trained steps and evals), the program's counter
``kernels.bytes.spmm.gather_k1`` (``ops/spmm.py``: E x F x itemsize a
call on the gather route) over the trained steps."""

COUNTER = "kernels.bytes.spmm.gather_k1"


def read(ctx):
    n = (ctx["program"] or {}).get("counters", {}).get(COUNTER)
    steps = ctx["facts"]["steps"]
    if not n or not steps:
        ctx["log"](f"message_gib.gin_mlp.train: no {COUNTER} counter")
        return None
    return n / 2 ** 30 / steps
