"""message_gib.gcnii.serve: GiB of (E, F) message matrices a traced
request writes, the program's counter ``kernels.bytes.spmm.gather_k1``
(``ops/spmm.py``: E x F x itemsize a call on the gather route) over the
requests: how much of GCNII's propagation falls off K8. 0 where every
aggregation the route counters saw took K8; nothing where the program
counted no aggregation."""

COUNTER = "kernels.bytes.spmm.gather_k1"
ROUTES = ("kernels.routes.spmm.k8_tiles", "kernels.routes.spmm.gather_k1")


def read(ctx):
    counters = (ctx["program"] or {}).get("counters", {})
    if not any(counters.get(k) for k in ROUTES):
        ctx["log"]("message_gib.gcnii.serve: no spmm route counter")
        return None
    return counters.get(COUNTER, 0) / 2 ** 30 / ctx["facts"]["requests"]
