"""The benchmark's harness: cell resolution, inputs and weights from the
seed, the drives of the timed path, tracing and the comparison."""
