"""aggregate_ms.gin_mlp.train: device ms a trained step spends in GIN's
forward neighbour sums, the program's ``step.aggregate`` stamps
(``models/layers.py`` ``GINConv``; the sums' backward is the backward's)
over the traced epochs' steps."""

SEGMENT = "step.aggregate"


def read(ctx):
    seg = (ctx["program"] or {}).get("segments", {}).get(SEGMENT)
    steps = ctx["facts"]["steps"]
    if not seg or not steps:
        ctx["log"](f"aggregate_ms.gin_mlp.train: no {SEGMENT} stamps")
        return None
    return 1e3 * seg["s"] / steps
