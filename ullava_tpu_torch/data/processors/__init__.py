from ullava_tpu_torch.data.processors.clip_processor import CLIPProcessor  # noqa: F401
