from ullava_tpu_torch.data.datasets.base_dataset import BaseDataset  # noqa: F401
from ullava_tpu_torch.data.datasets.llava_dataset import LLaVADataset, LLaVASegDataset  # noqa: F401
from ullava_tpu_torch.data.datasets.res_dataset import ResDataset, ValResDataset  # noqa: F401
from ullava_tpu_torch.data.datasets.sem_seg_dataset import (  # noqa: F401
    CocoStuffDataset,
    PacoDataset,
    SemanticSegDataset,
)
from ullava_tpu_torch.data.datasets.salient_seg_dataset import (  # noqa: F401
    SalientSegDataset,
    ValSalientSegDataset,
)
from ullava_tpu_torch.data.datasets.concat_dataset import (  # noqa: F401
    ConcatDataset,
    ConcatDatasetWithShuffle,
)
