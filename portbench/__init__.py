"""The port's benchmark: a data-driven harness over ``ucnerf_torch``."""
