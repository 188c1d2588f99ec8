"""VAST in PyTorch for one NVIDIA H100 (Hopper, sm_90a).

A port of ``vast_tpu`` that stands on its own: it imports torch and numpy,
never JAX or ``vast_tpu``. Module names mirror ``vast_tpu`` so each
counterpart is easy to find. The attention kernels that ``vast_tpu`` wrote
in Pallas for the TPU are hand-written CUDA here (``csrc/``), built with
``nvcc`` at first use and bound with ctypes.

Entry points (``models.vast.VASTModel``, ``evaluation.evaluation_mm.
evaluate_ret``) run on the GPU unless the caller passes ``device="cpu"``.
"""
