"""Checkpoint reading and writing."""
