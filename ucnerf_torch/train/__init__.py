"""The train loop: the train step, its losses and the eval render; the
entry point ``python -m ucnerf_torch.train``."""
