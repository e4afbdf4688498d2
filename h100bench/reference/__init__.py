"""The benchmark's plain PyTorch reference (model, weights, FLOP count)."""
