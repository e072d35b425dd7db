"""The port's demos: ``python3 -m graphcast_tpu_torch.examples.<name>``."""
