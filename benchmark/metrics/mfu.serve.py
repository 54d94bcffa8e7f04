"""mfu.serve: the model operations of the traced requests (per request
the scorer over every valid edge and one backbone forward per draw,
counted by ``benchmark/counts.py``) over (window x the bf16 peak), in %."""
from benchmark import counts


def read(ctx):
    sh, f, cell = ctx["shapes"], ctx["facts"], ctx["cell"]
    cfg = cell.ref_cfg()
    ops = sum(counts.eval_flops(cfg, cell.mode, sh["n"][p], sh["e"][p],
                                sh["q"], sh["draws"]) for p in f["parts"])
    return 100.0 * ops / (ctx["trace"].window_s * counts.PEAK_BF16_FLOPS)
