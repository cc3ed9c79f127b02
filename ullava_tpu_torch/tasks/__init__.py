"""Task layer: registry dispatch on the config's `task.type` (counterpart
of `ullava_tpu/tasks/`)."""

import ullava_tpu_torch.data  # noqa: F401  (registers processors, builders, collators)
from ullava_tpu_torch.registry import registry
from ullava_tpu_torch.tasks.base_task import BaseTask  # noqa: F401
from ullava_tpu_torch.tasks.image_text_pretrain import ImageTextPretrainTask  # noqa: F401
from ullava_tpu_torch.tasks.image_text_evaluate import ImageTextEvaluateTask  # noqa: F401


def setup_task(task_cfg):
    cls = registry.get_task_class(task_cfg.get("type"))
    if cls is None:
        raise KeyError(f"task '{task_cfg.get('type')}' is not registered")
    return cls(task_cfg)
