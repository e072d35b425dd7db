"""The optimizer's share of a training step's device time, in %: the
kernels of ``ClippedAdamW.step`` (the gradients' global norm, the clip,
AdamW's foreach update), named in ``OPTIMIZER``."""

from portbench import readers

OPTIMIZER = readers.kernels(
    r"multi_tensor_apply_kernel|lpnorm|[Aa]dam|foreach_norm|"
    r"_foreach")


def read(ctx):
  return readers.share(ctx, OPTIMIZER)
