"""aggregate_ms.gin_mlp.serve: device ms a traced request spends in
GIN's neighbour sums, the program's ``serve.aggregate`` stamps
(``models/layers.py`` ``GINConv``) over the requests."""

SEGMENT = "serve.aggregate"


def read(ctx):
    seg = (ctx["program"] or {}).get("segments", {}).get(SEGMENT)
    if not seg:
        ctx["log"](f"aggregate_ms.gin_mlp.serve: no {SEGMENT} stamps")
        return None
    return 1e3 * seg["s"] / ctx["facts"]["requests"]
