"""Predictors: GraphCast, GenCast (denoiser, sparse transformer), their
configs and presets."""
