"""Synthetic data for training."""
