"""Training: synthetic data, AdamW, the train step, checkpoints and the
resumable loop (port of ``repro/train``)."""
