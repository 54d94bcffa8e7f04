from .losses import (assortative_bce, assortative_bce_flags,
                     consistency_loss, masked_cross_entropy, micro_f1)
from .optim import DualOptimizer
from .pipelines import (StepMetrics, make_baseline_loss, make_learned_loss,
                        make_scan_epoch_step, make_train_step)

__all__ = ["assortative_bce", "assortative_bce_flags", "consistency_loss",
           "masked_cross_entropy", "micro_f1", "DualOptimizer",
           "StepMetrics", "make_baseline_loss", "make_learned_loss",
           "make_scan_epoch_step", "make_train_step"]
