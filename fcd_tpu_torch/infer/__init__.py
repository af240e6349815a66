"""Sliding-window inference of the port."""
