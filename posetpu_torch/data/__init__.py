"""Data layer: the reference annotation schema, datasets, the synthetic
split and the decode-only host loader with its CUDA batch placer."""

from posetpu_torch.data.datasets import LspDataset, MpiiDataset, PoseDataset
from posetpu_torch.data.loader import (
    CudaBatchPlacer,
    HostLoader,
    load_sample,
    make_batch_placer,
    pad_batch,
    threaded_place_iter,
)
from posetpu_torch.data.schema import SampleMeta, dump_annotations, load_annotations
from posetpu_torch.data.synthetic import make_synthetic_dataset

__all__ = [
    "CudaBatchPlacer",
    "HostLoader",
    "LspDataset",
    "MpiiDataset",
    "PoseDataset",
    "SampleMeta",
    "dump_annotations",
    "load_annotations",
    "load_sample",
    "make_batch_placer",
    "make_synthetic_dataset",
    "pad_batch",
    "threaded_place_iter",
]
