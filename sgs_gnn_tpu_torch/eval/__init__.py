from .evaluate import aggregate_eval, make_eval_step

__all__ = ["aggregate_eval", "make_eval_step"]
