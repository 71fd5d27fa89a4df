"""Training of the port: targets, samplers, the AdamW + EMA step and the trainer."""
