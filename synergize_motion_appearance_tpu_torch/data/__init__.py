"""The training data pipeline (counterpart of the JAX package's data/):
the frame-folder dataset, the sampler, the threaded loader and the native
frame cache. All host-side numpy; batches are NHWC float32."""
from .frames_dataset import FramesMotionTransferDataset, build_dataset
from .loader import BatchLoader, infinite_batches
from .sampler import EnlargedSampler
from .transforms import augment_video

__all__ = ["BatchLoader", "EnlargedSampler", "FramesMotionTransferDataset",
           "augment_video", "build_dataset", "infinite_batches"]
