from .evaluate import (accumulate_eval_device, aggregate_eval, make_eval_step,
                       make_scan_eval_step)

__all__ = ["accumulate_eval_device", "aggregate_eval", "make_eval_step",
           "make_scan_eval_step"]
