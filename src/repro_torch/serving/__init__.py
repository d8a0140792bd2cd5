"""Bucketing, sampling and generation."""
