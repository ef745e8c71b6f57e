"""Training: AdamW, gradient compression, the synthetic data pipeline, the
train step, checkpoints and the resumable supervisor loop (port of
``repro/train``); the checkpoint module's framed and atomic file helpers
also serve the serving resilience layer and the streaming index."""
