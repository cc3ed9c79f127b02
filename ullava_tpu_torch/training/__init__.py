"""Training of the port (counterparts of `ullava_tpu/training/`)."""
