"""The data pipeline (counterpart of the JAX package's data/): the
frame-folder training dataset, the CSV pair datasets of evaluation, the
sampler, the threaded loader and the native frame cache. All host-side
numpy; batches are NHWC float32."""
from .frames_dataset import (
    FramesMotionTransferDataset,
    FramesMotionTransferTestDataset_CrossID_videopair_anchor,
    FramesMotionTransferTestDataset_PairsList,
    build_dataset,
)
from .loader import BatchLoader, infinite_batches
from .sampler import EnlargedSampler
from .transforms import augment_video

__all__ = ["BatchLoader", "EnlargedSampler", "FramesMotionTransferDataset",
           "FramesMotionTransferTestDataset_CrossID_videopair_anchor",
           "FramesMotionTransferTestDataset_PairsList", "augment_video",
           "build_dataset", "infinite_batches"]
