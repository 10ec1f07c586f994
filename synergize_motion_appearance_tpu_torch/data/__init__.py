"""The data pipeline (counterpart of the JAX package's data/): the
frame-folder training dataset, the CSV pair datasets of evaluation, the
sampler, the threaded loader, the native frame cache and data_util's path
helpers and DUF downsample. Host-side numpy, but for duf_downsample, which
runs in torch on its input's device; batches are NHWC float32."""
from .frames_dataset import (
    FramesMotionTransferDataset,
    FramesMotionTransferTestDataset_CrossID_videopair_anchor,
    FramesMotionTransferTestDataset_PairsList,
    build_dataset,
)
from .data_util import (
    duf_downsample,
    generate_frame_indices,
    paired_paths_from_folder,
    paired_paths_from_lmdb,
    paired_paths_from_meta_info_file,
    paths_from_folder,
    paths_from_lmdb,
    read_img_seq,
)
from .loader import BatchLoader, infinite_batches
from .sampler import EnlargedSampler
from .transforms import augment_video

__all__ = ["BatchLoader", "EnlargedSampler", "FramesMotionTransferDataset",
           "FramesMotionTransferTestDataset_CrossID_videopair_anchor",
           "FramesMotionTransferTestDataset_PairsList", "augment_video",
           "build_dataset", "duf_downsample", "generate_frame_indices",
           "infinite_batches", "paired_paths_from_folder",
           "paired_paths_from_lmdb", "paired_paths_from_meta_info_file",
           "paths_from_folder", "paths_from_lmdb", "read_img_seq"]
