"""Data parallelism: rank groups, the zero-weight pad plan, gradient sums."""
