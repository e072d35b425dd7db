"""Host-side graph geometry (numpy copies of graphcast_tpu/geometry)."""
