# ``finetune`` stays the submodule's name here (``from repro_torch.train
# import finetune as FT`` is how the package reaches it), so its function of
# the same name is not re-exported.
from repro_torch.train.finetune import compute_fisher, evaluate
from repro_torch.train.losses import lm_loss
from repro_torch.train.multitask import train_multitask
from repro_torch.train.pretrain import pretrain_mlm
from repro_torch.train.step import make_eval_step, make_train_state, make_train_step

__all__ = ["compute_fisher", "evaluate", "lm_loss", "make_eval_step", "make_train_state",
           "make_train_step", "train_multitask", "pretrain_mlm"]
