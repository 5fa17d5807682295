"""Data layer: the reference annotation schema, datasets, the synthetic
split, the decode-only host loader with its CUDA batch placer, and the
loader that decodes in worker processes."""

from posetpu_torch.data.datasets import LspDataset, MpiiDataset, PoseDataset
from posetpu_torch.data.loader import (
    CudaBatchPlacer,
    HostLoader,
    group_stack,
    load_sample,
    make_batch_placer,
    pad_batch,
    threaded_place_iter,
)
from posetpu_torch.data.schema import SampleMeta, dump_annotations, load_annotations
from posetpu_torch.data.synthetic import make_synthetic_dataset
from posetpu_torch.data.worker_loader import WorkerLoader

__all__ = [
    "CudaBatchPlacer",
    "HostLoader",
    "LspDataset",
    "MpiiDataset",
    "PoseDataset",
    "SampleMeta",
    "WorkerLoader",
    "dump_annotations",
    "group_stack",
    "load_annotations",
    "load_sample",
    "make_batch_placer",
    "make_synthetic_dataset",
    "pad_batch",
    "threaded_place_iter",
]
