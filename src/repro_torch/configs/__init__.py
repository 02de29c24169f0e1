"""Architecture registry of the port. Only the paper's own target is
registered so far; the other architectures wait for their stacks."""
from repro_torch.configs import vicuna_7b  # noqa: F401
