"""Optimizers, learning-rate schedules and the gradient codec."""
from repro_torch.optim.compression import (dequantize_grads_po2,  # noqa: F401
                                           quantize_grads_po2)
from repro_torch.optim.optimizers import (OptState, Optimizer,  # noqa: F401
                                          adafactor, adamw,
                                          clip_by_global_norm)
from repro_torch.optim.schedule import warmup_cosine, warmup_linear  # noqa: F401
