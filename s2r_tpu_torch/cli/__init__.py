"""The command-line drivers: train_adapt, val_adapt, val."""
