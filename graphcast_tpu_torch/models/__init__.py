"""Predictors: the GraphCast model, its configs and presets."""
