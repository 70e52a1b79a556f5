"""The plain reference that decides a run's `correct`.

A frozen copy of the port's plain routes, taken when the benchmark was
written: the same modules, with every hand-written kernel route removed
(each operator runs its plain tensor-op version on any device), the
(data, points) mesh reduced to one process (`parallel/mesh.py`), every SA
level on its plain path, the entry points no cell drives left out, and
one addition for the lower-precision control
(`models/layers.py::mark_fp8`).  It imports nothing of the program: later
changes to the program do not move it.  Module docstrings describe the
port module each file was copied from."""
