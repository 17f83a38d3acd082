"""Frozen arithmetic of the benchmark: the card's peaks, the work of the
port's kernels and the model FLOPs of a training step.  Later changes to
the program do not move these yardsticks."""
