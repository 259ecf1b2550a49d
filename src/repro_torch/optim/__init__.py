"""Optimizers (port of ``repro/optim``): init/update pairs over the port's
parameter trees, with the JAX package's arithmetic."""
from repro_torch.optim.adamw import adamw
from repro_torch.optim.sgd import sgd
from repro_torch.optim.schedules import (constant, cosine_warmup,
                                         plateau_halving, EarlyStopper,
                                         PlateauHalver, Schedule)
from repro_torch.optim.common import (Optimizer, apply_updates,
                                      clip_by_global_norm, chain_clip,
                                      value_and_grad)
from repro_torch.optim.accum import gradient_accumulation
