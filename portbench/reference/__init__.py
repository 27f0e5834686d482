"""The plain reference of the benchmark's cells.

``mgref/`` is a frozen copy of the port's plain paths (the env engine, the
observations, the policies and the PPO steps), with every kernel replaced
by its plain version: it imports nothing of the port, of ``jax`` or of the
JAX package. ``follow.py`` builds it from a configuration file and follows
what the program's timed path produced.
"""
