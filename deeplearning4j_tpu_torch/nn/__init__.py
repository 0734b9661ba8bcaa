"""Layers, configuration and initialisers (inference)."""
