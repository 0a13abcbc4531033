"""The command-line drivers: train, train_adapt, val, val_adapt, test,
test_adapt."""
