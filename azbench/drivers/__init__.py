"""The general drivers a traffic mix names by its ``driver`` key: each has
``setup(run)``, ``window(run, state)``, ``check(run, state)`` and
``close(state)`` (see azbench/harness.py)."""
