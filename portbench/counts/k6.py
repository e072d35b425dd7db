"""K6, the block-sparse attention's forward (ops/splash.py
``block_sparse_attention``, csrc/splash_fwd.cu), as chip_smoke.py counts
it: q·kᵀ and the weights times v over the mask's pairs for each (member,
head); q, k, v read and the output written once in bf16, the float32
log-sum-exp written once."""


def count(batch: int, heads: int, nodes: int, head_dim: int, mask_nnz: int
          ) -> tuple[float, float]:
  """(operations, bytes) of one launch over ``batch`` x ``heads`` folded
  heads of ``nodes`` rows."""
  flops = 4 * batch * heads * mask_nnz * head_dim
  nbytes = batch * (4 * nodes * heads * head_dim * 2 + nodes * heads * 4)
  return float(flops), float(nbytes)
