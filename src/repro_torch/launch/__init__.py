"""Drivers of the port: ``serve`` (batched greedy serving of the dense LMs)."""
