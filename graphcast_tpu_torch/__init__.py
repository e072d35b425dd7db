"""PyTorch + CUDA port of graphcast_tpu, for NVIDIA Hopper (H100).

The JAX package ``graphcast_tpu`` is the reference; this package mirrors its
module layout and names. Ported so far: GraphCast's batch-1 inference
rollout, ``Autoregressive(InputsAndResiduals(Bfloat16Cast(GraphCast)))``,
with its two TPU kernels rewritten for Hopper in CUDA C++ (``csrc/``):

- ``ops.fused_edge`` (K1): the fused InteractionNetwork edge step, for the
  mesh processor and the grid2mesh encoder;
- ``ops.fused_decoder`` (K2): the whole mesh2grid decoder.

Each has a plain-PyTorch twin, used for CPU tensors; CUDA tensors always
take the kernel. ``python3 chip_smoke.py`` drives the port on a GPU.
This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
