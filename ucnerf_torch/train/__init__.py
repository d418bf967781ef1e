"""The eval render of the train loop (the train step comes later)."""
