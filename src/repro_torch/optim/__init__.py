from repro_torch.optim.adamw import (OptConfig, adamw_update, clip_by_global_norm,
                                     global_norm, init_opt_state, lr_at,
                                     opt_state_defs)

__all__ = ["OptConfig", "adamw_update", "init_opt_state", "lr_at",
           "clip_by_global_norm", "global_norm", "opt_state_defs"]
