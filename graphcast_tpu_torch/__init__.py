"""PyTorch + CUDA port of graphcast_tpu, for NVIDIA Hopper (H100).

The JAX package ``graphcast_tpu`` is the reference; this package mirrors its
module layout and names. Ported so far, at batch 1:

- GraphCast through ``Autoregressive(InputsAndResiduals(Bfloat16Cast(
  GraphCast)))``: the inference rollout and training (``losses``, the
  wrappers' ``loss``, ``train.make_train_step`` with the paper's AdamW
  schedule);
- GenCast sampling through ``NaNCleaner(InputsAndResiduals(GenCast))``: the
  norm-conditioned denoiser with its sparse transformer, DPM-Solver++ 2S
  with stochastic churn, and spherical-harmonic noise.

The TPU kernels on those paths are rewritten for Hopper in CUDA C++
(``csrc/``):

- ``ops.fused_edge`` (K1 and its backward K4): the fused InteractionNetwork
  edge step, for the mesh processor, the grid2mesh encoder and, in embed
  mode, GenCast's grid2mesh;
- ``ops.fused_decoder`` (K2 and its backward K5): the whole mesh2grid
  decoder, plain and embed mode;
- ``ops.splash`` (K6): block-sparse attention over the k-hop mesh mask.

Each has a plain-PyTorch twin, used for CPU tensors (under autograd for
gradients); CUDA tensors always take the kernels. Entry points put their
tensors on the card unless the caller passes ``device="cpu"``.
``parallel`` runs these paths over ``torch.distributed`` meshes (data and
ensemble parallelism, Megatron-paired tensor parallelism, sequence-parallel
splash attention); ``graft_entry`` holds the twins of the repository root's
``__graft_entry__`` (a forward step, the multi-process dry run).
``python3 chip_smoke.py`` drives the port on a GPU. This package imports
``torch`` and never ``jax``.
"""

__version__ = "0.1.0"
