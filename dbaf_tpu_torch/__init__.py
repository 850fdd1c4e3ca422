"""PyTorch/CUDA port of dbaf_tpu: the visual DBA-Fusion path on an NVIDIA H100.

The JAX package ``dbaf_tpu`` is the reference; this package imports none of
it.  Entry points default to the CUDA device and raise without one unless
the caller passes ``device=\"cpu\"``.
"""
