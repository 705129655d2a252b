"""Parameter and optimizer-state broadcast, and DistributedOptimizer."""
