"""One module per kind of run a traffic file names (its ``kind``), each
with ``run_cell(cell, seed, seconds, trace, ...)`` returning the run's
record and ``judge(record, limits)`` deciding ``correct``."""
