"""Data parallel training across processes."""
