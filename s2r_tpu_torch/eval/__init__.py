"""Segmentation metrics: the confusion matrix and the Evaluator."""
