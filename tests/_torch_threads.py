"""The thread policy of the port's CPU tests: torch's CPU ops run on the
calling thread only, in every ``tests/test_torch_*.py`` module.

Each of those modules imports :func:`one_torch_thread`, a module-scoped
autouse fixture that sets ``torch.set_num_threads(1)`` for the module's
tests and restores the previous count after them. Two reasons:

- Agreement. In a process that has run JAX, torch's ``exp`` of a bench
  scene's 6,144 log-scales came back up to 1.5e-4 off on one worker
  thread's chunk in a few first calls (the calling thread's chunk never
  was): that moved the bench's gradient 5.7e-4 x its max, over the
  gradient bar (ROADMAP, "torch's CPU exp on a worker thread").
- Speed. The suite runs under xdist in several worker processes at once;
  torch on every core in each oversubscribes the machine (six workers of
  eight threads on eight cores). There a float64 depthwise ``conv2d`` of
  SSIM's plain version took 0.08-0.78 s against about 0.1 ms on one
  thread, and a ``gradcheck`` of it ran for 17 minutes. The small ops of
  these tests are no faster on more threads.

Rank processes (``parallel.local.run``) and subprocesses start with
torch's own default.
"""
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
