from ullava_tpu_torch.utils.tools import datetime_print, set_seed  # noqa: F401
from ullava_tpu_torch.utils.profiling import phase_timer, trace  # noqa: F401
