"""Subpackage of stylesinger_torch."""
