from repro_torch.core import fusion
from repro_torch.core.cold_fusion import ColdFusionRun, EvalTask, evaluate_base_model, run_cold_fusion
from repro_torch.core.contributor import Contributor
from repro_torch.core.distributed import (ColdSchedule, cold_shardings, make_cold_train_step,
                                          make_fuse_step, num_contributors,
                                          stack_for_contributors)
from repro_torch.core.repository import (FAMILY_DIR, FusionRecord, Repository, RepositoryFamily,
                                         family_member_root)
from repro_torch.core.validation import screen_contributions, screen_norms

__all__ = [
    "fusion", "ColdFusionRun", "EvalTask", "evaluate_base_model", "run_cold_fusion",
    "Contributor", "ColdSchedule", "cold_shardings", "make_cold_train_step",
    "make_fuse_step", "num_contributors", "stack_for_contributors", "FAMILY_DIR",
    "FusionRecord", "Repository", "RepositoryFamily", "family_member_root",
    "screen_contributions", "screen_norms",
]
