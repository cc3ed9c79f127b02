from ullava_tpu_torch.data.builders.base_builder import BaseDatasetBuilder  # noqa: F401
from ullava_tpu_torch.data.builders import plain_type_builder  # noqa: F401
from ullava_tpu_torch.data.builders import template_type_builder  # noqa: F401
