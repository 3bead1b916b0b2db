"""What the benchmark measures with: the trace arithmetic, the card's
peaks, the operation and byte counts of the port's kernels, and the
statistics of the end-to-end metrics."""
