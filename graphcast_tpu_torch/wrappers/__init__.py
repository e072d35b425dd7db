from graphcast_tpu_torch.wrappers.autoregressive import Autoregressive  # noqa: F401
from graphcast_tpu_torch.wrappers.casting import Bfloat16Cast  # noqa: F401
from graphcast_tpu_torch.wrappers.normalization import InputsAndResiduals  # noqa: F401
from graphcast_tpu_torch.wrappers.nan_cleaning import NaNCleaner  # noqa: F401
