"""Training, on one device or sharded over a device mesh: the AdamW
optimizer, the synthetic data stream, int8 error-feedback gradient
compression and its ring all-reduce, atomic checkpoints that restore
onto any mesh, and the fault-tolerant train loop (the counterpart of
``repro/training``)."""
