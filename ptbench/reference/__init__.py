"""The plain reference of the served models: float32 PyTorch, no kernels,
no cache, no batching. It imports nothing of the program."""
