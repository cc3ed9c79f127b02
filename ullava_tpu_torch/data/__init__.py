"""Host-side data layer of the port (counterpart of `ullava_tpu/data/`):
processors, datasets, builders, collators, the loader and the tools.

Collators emit dense padded numpy arrays with validity masks; the loader
turns them into torch tensors on the train step's device. Importing this
package registers every processor, builder and collator with the port's
registry (the YAML names are the config surface).
"""

from ullava_tpu_torch.data import builders, collators, processors  # noqa: F401
from ullava_tpu_torch.data.loader import DataLoader  # noqa: F401
from ullava_tpu_torch.data.tools.mask_toolbox import DetToolBox, SegToolBox  # noqa: F401
from ullava_tpu_torch.data.tools import rle  # noqa: F401
