from repro_torch.optim.optimizers import (Optimizer, adafactor, adamw, clip_by_global_norm,
                                          constant_lr, global_norm, linear_decay_lr,
                                          make_optimizer, sgd, warmup_cosine_lr)

__all__ = ["Optimizer", "adafactor", "adamw", "clip_by_global_norm", "constant_lr",
           "global_norm", "linear_decay_lr", "make_optimizer", "sgd", "warmup_cosine_lr"]
