"""buctd_tpu_torch — the PyTorch/CUDA port of buctd_tpu for NVIDIA Hopper.

A second package beside the JAX one, which stays the reference.  Module names
mirror buctd_tpu's so each counterpart is easy to find.  Models are NCHW
``nn.Module``s with the BUCTD reference's state_dict names; the ops keep the
JAX functions' layouts at their signatures.  Every Pallas kernel on a ported
path is a hand-written CUDA kernel under ``csrc/``, built with nvcc at first
use (``_build.py``).  Entry points run on CUDA unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"
