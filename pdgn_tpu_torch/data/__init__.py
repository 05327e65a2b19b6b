"""Data layer of the port: datasets, augmentations, the hdf5 reader and
the device-feeding loader (port of pdgn_tpu/data)."""

from pdgn_tpu_torch.data.loader import (
    Subset,
    get_data_iterator,
    get_train_val_test_datasets,
    prefetch_to_device,
    random_split,
    split_sizes,
    train_loader,
)
from pdgn_tpu_torch.data.modelnet import ModelNetDataset, pc_normalize
from pdgn_tpu_torch.data.partdataset import PartDataset
from pdgn_tpu_torch.data.shapenet import (
    RESOLUTIONS,
    ShapeNetCore,
    SyntheticShapes,
    batch_iterator,
    cate_to_synsetid,
    normalize_cloud,
    synsetid_to_cate,
)

__all__ = [
    "ModelNetDataset",
    "Subset",
    "get_train_val_test_datasets",
    "random_split",
    "PartDataset",
    "RESOLUTIONS",
    "ShapeNetCore",
    "SyntheticShapes",
    "batch_iterator",
    "cate_to_synsetid",
    "get_data_iterator",
    "normalize_cloud",
    "pc_normalize",
    "prefetch_to_device",
    "split_sizes",
    "synsetid_to_cate",
    "train_loader",
]
