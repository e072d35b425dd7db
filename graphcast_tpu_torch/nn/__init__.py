"""Modules: Linear/MLP/LayerNorm (core) and the deep typed-graph GNN."""
