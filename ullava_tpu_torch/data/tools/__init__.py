from ullava_tpu_torch.data.tools.mask_toolbox import DetToolBox, SegToolBox  # noqa: F401
