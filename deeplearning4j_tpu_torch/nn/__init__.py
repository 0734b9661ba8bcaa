"""Layers, configuration, initialisers, losses and updaters."""
