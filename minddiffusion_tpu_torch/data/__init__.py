from minddiffusion_tpu_torch.data.dataset import TextImageDataset, load_data
from minddiffusion_tpu_torch.data.dataset_db import DreamBoothDataset

__all__ = ["TextImageDataset", "load_data", "DreamBoothDataset"]
