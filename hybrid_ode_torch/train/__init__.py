"""Training: optimizer, train / eval steps, `train_model`, CLI."""
