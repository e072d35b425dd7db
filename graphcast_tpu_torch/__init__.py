"""PyTorch + CUDA port of graphcast_tpu, for NVIDIA Hopper (H100).

The JAX package ``graphcast_tpu`` is the reference; this package mirrors its
module layout and names. Ported so far: GraphCast at batch 1 through
``Autoregressive(InputsAndResiduals(Bfloat16Cast(GraphCast)))`` — the
inference rollout, and training (``losses``, the wrappers' ``loss``,
``train.make_train_step`` with the paper's AdamW schedule) — with its four
TPU kernels rewritten for Hopper in CUDA C++ (``csrc/``):

- ``ops.fused_edge`` (K1 and its backward K4): the fused InteractionNetwork
  edge step, for the mesh processor and the grid2mesh encoder;
- ``ops.fused_decoder`` (K2 and its backward K5): the whole mesh2grid
  decoder.

Each has a plain-PyTorch twin, used for CPU tensors (under autograd for
gradients); CUDA tensors always take the kernels. ``python3 chip_smoke.py``
drives the port on a GPU. This package imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
