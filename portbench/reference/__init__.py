"""The plain reference and the benchmark's frozen arithmetic.

Imports nothing of ``ucnerf_torch``.
"""
