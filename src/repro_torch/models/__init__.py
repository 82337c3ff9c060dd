"""Model workloads built on the solver."""
