"""Feeding host batches to the device."""
