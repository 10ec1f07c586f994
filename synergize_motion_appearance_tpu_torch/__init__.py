"""PyTorch and CUDA port of the reenactment system, for NVIDIA Hopper.

The JAX package ``synergize_motion_appearance_tpu`` beside it is the
reference. This package imports nothing of it: modules here carry the same
names as their JAX counterparts (``ops/``, ``models/``, ``inference.py``)
and compute the same functions with NCHW tensors inside and the JAX
package's NHWC layout at the pipeline's public API. Module and parameter
names follow the upstream torch reference, so a reference-named
state_dict loads with ``strict=True``; ``weights.py`` turns the JAX
package's parameter trees into such state_dicts.
"""

__version__ = "0.1.0"
