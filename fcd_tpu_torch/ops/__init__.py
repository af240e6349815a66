"""Eval layers, blocks and attention of the port."""
