from repro_torch.optim.optimizers import (  # noqa: F401
    Adafactor,
    AdamW,
    cosine_schedule,
    get_optimizer,
)
