"""The plain reference the port is held to: plain PyTorch, no kernels, and
nothing of the program under test (``render``: projection, SH colours,
tile lists and compositing; ``train``: the loss, autograd and Adam)."""
