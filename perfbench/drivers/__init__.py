"""One module per entry that a cell's window drives (``driver`` in the
cell's file). Each has ``run(cell, seed, seconds, trace, device, t_start)``
and returns the run's record for the metric readers and the checks."""
