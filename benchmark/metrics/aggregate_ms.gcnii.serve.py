"""aggregate_ms.gcnii.serve: device ms a traced request spends in GCNII's
propagations, the program's ``serve.aggregate`` stamps
(``models/layers.py`` ``GCN2Conv``) over the requests."""

SEGMENT = "serve.aggregate"


def read(ctx):
    seg = (ctx["program"] or {}).get("segments", {}).get(SEGMENT)
    if not seg:
        ctx["log"](f"aggregate_ms.gcnii.serve: no {SEGMENT} stamps")
        return None
    return 1e3 * seg["s"] / ctx["facts"]["requests"]
