"""Models trained on the port's features.

- :mod:`repro_torch.models.widedeep` — Wide&Deep over columnar ADV
  features, the wide part through the ``onehot_wide`` CUDA kernel in both
  directions.
"""
from repro_torch.models.widedeep import (WideDeepConfig, forward_widedeep,
                                         init_widedeep, loss_widedeep,
                                         make_widedeep_train_step,
                                         params_from_reference,
                                         params_to_numpy)

__all__ = ["WideDeepConfig", "init_widedeep", "forward_widedeep",
           "loss_widedeep", "make_widedeep_train_step",
           "params_from_reference", "params_to_numpy"]
