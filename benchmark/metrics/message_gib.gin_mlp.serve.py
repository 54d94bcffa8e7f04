"""message_gib.gin_mlp.serve: GiB of (E, F) message matrices a traced
request writes, the program's counter ``kernels.bytes.spmm.gather_k1``
(``ops/spmm.py``: E x F x itemsize a call on the gather route) over the
requests."""

COUNTER = "kernels.bytes.spmm.gather_k1"


def read(ctx):
    n = (ctx["program"] or {}).get("counters", {}).get(COUNTER)
    if not n:
        ctx["log"](f"message_gib.gin_mlp.serve: no {COUNTER} counter")
        return None
    return n / 2 ** 30 / ctx["facts"]["requests"]
