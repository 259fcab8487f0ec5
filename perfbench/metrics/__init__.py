"""One reader per metric, ``<metric>.py`` with ``read(record)``: the
metric's value from a run's record, or ``None`` where the run has
nothing for it to read (the metric is then left out of the line)."""
