from repro_torch.train.fault import (FaultEvent, FaultLog, MeshPlan,
                                     StragglerDetector, plan_elastic_mesh)
from repro_torch.train.optimizer import (OptConfig, apply_updates,
                                         init_opt_state)
from repro_torch.train.schedule import SCHEDULES
from repro_torch.train.trainer import TrainConfig, Trainer, make_train_step

__all__ = ["StragglerDetector", "MeshPlan", "plan_elastic_mesh",
           "FaultEvent", "FaultLog", "OptConfig", "apply_updates",
           "init_opt_state", "SCHEDULES", "TrainConfig", "Trainer",
           "make_train_step"]
