"""The traffic generators: each run's data, made from its seed."""
