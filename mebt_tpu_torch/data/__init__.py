from mebt_tpu_torch.data.datasets import (  # noqa: F401
    FrameListDataset,
    HDF5PreprocessedDataset,
    HDF5VTokensDataset,
    VideoData,
    VideoFileDataset,
)
from mebt_tpu_torch.data.loader import DataLoader  # noqa: F401
