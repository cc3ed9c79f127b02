"""Host-side data helpers of the port (counterpart of `ullava_tpu/data/`):
the CLIP processor and the SAM / box toolboxes that inference uses."""
