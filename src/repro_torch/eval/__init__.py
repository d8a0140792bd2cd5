"""Evaluation metrics of the cache's hit decisions."""
