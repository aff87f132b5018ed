from repro_torch.optim.adamw import AdamW, cosine_schedule, sgd_momentum

__all__ = ["AdamW", "cosine_schedule", "sgd_momentum"]
