"""Featurization, rendering and serving."""
