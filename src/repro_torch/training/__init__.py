"""Training on one device: the AdamW optimizer, the synthetic data
stream, int8 error-feedback gradient compression, atomic checkpoints and
the fault-tolerant train loop (the counterpart of ``repro/training``)."""
