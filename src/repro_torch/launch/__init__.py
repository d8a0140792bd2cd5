"""Entry points that build a serving stack."""
