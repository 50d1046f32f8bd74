"""Training substrate of the port: AdamW, ``.rpck`` checkpoints and the
single-device Trainer."""
