from repro_torch.optim.adamw import AdamW, AdamW8bit, make_optimizer  # noqa: F401
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
