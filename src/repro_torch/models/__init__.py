"""Models of the port.

- :mod:`repro_torch.models.widedeep` — Wide&Deep over columnar ADV
  features, the wide part through the ``onehot_wide`` CUDA kernel in both
  directions.
- :mod:`repro_torch.models.lm` — the LM the ADV/embedding path feeds
  (families ``dense`` and ``vlm``): parameters in the reference's layout,
  forward, and the prefill/decode serve steps over a KV cache; built from
  :mod:`~repro_torch.models.blocks`, :mod:`~repro_torch.models.attention`,
  :mod:`~repro_torch.models.flash` and :mod:`~repro_torch.models.layers`.
"""
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import (decode_step, forward, init_params,
                                   init_serve_state, param_specs, prefill)
from repro_torch.models.widedeep import (WideDeepConfig, forward_widedeep,
                                         init_widedeep, loss_widedeep,
                                         make_widedeep_train_step,
                                         params_from_reference,
                                         params_to_numpy)

__all__ = ["WideDeepConfig", "init_widedeep", "forward_widedeep",
           "loss_widedeep", "make_widedeep_train_step",
           "params_from_reference", "params_to_numpy",
           "ModelConfig", "init_params", "param_specs", "forward",
           "init_serve_state", "prefill", "decode_step"]
