"""Training objectives: one file an objective (``<name>.py``), named by a
configuration's ``objective`` key and loaded by path. Each gives ``CHECKS``
and ``check(inputs)`` (a ``cells.TrainInputs``), and for the control
``reference(inputs)``; see README.md."""
