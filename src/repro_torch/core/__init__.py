"""Semantic cache, router, tweak prompts and the serving engine."""
