from ullava_tpu_torch.data.collators.collators import (  # noqa: F401
    BaseCollator,
    GroundingCollator,
    ImageCollator,
    ImageVideoCollator,
    SegmentationCollator,
    VideoCollator,
)
