"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, no
sparsity), at the full 700 W power limit."""

BF16_FLOPS = 989e12      # tensor cores, bf16 and fp16
F32_FLOPS = 67e12        # outside the tensor cores
HBM_BYTES = 3.35e12      # HBM3, bytes/s


def bound_s(flops: float, nbytes: float, peak_flops: float = BF16_FLOPS
            ) -> float:
  """The least time the work could take: operations over their peak rate
  or bytes over the memory rate, whichever is larger."""
  return max(flops / peak_flops, nbytes / HBM_BYTES)
