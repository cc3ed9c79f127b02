from ullava_tpu_torch.data.processors.base_processor import BaseProcessor  # noqa: F401
from ullava_tpu_torch.data.processors.clip_processor import CLIPProcessor  # noqa: F401
from ullava_tpu_torch.data.processors.video_processor import (  # noqa: F401
    GIFTrainProcessor,
    VideoEvalProcessor,
    VideoTrainProcessor,
)
