"""mfu.train: the model operations of the traced epochs (every sampled
step and every partition's eval, counted from the shapes by
``benchmark/counts.py``) over (window x the bf16 peak), in %."""
from benchmark import counts


def read(ctx):
    sh, f, cell = ctx["shapes"], ctx["facts"], ctx["cell"]
    cfg, mode = cell.ref_cfg(), cell.mode
    per_epoch = sum(counts.train_step_flops(cfg, mode, n, e, sh["q"])
                    for n, e, a in zip(sh["n"], sh["e"], sh["plan"])
                    if a == 2)
    per_epoch += sum(counts.eval_flops(cfg, mode, n, e, sh["q"], sh["draws"])
                     for n, e in zip(sh["n"], sh["e"]))
    window = ctx["trace"].window_s
    return 100.0 * f["epochs"] * per_epoch / (window
                                              * counts.PEAK_BF16_FLOPS)
